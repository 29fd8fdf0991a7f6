"""Runs the JAX package's dry-run pieces that the port's dry run is held
against, and writes them as JSON, for ``test_torch_dryrun.py`` to read.

    python tests/torch_dryrun_ref.py OUT.json

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so this runs in a process of its own. It records, for every
assigned arch: the leaves of ``abstract_init``'s parameter tree (shape,
dtype, logical axes; GNNs at their first cell's input width), the
per-device parameter and optimizer bytes that ``shard_tree`` gives on the
(16, 16) and (2, 16, 16) production meshes (GNN parameters replicated, as
the reference's dry run places them), and each non-skipped cell's model
FLOPs from the reference's ``build_cell``; then the collective bytes
(``parse_collective_bytes``) and counts of one ``shard_map`` program of a
``psum``, an ``all_gather`` and a ``ppermute`` over four devices.
"""
import json
import sys

import repro.launch.dryrun as dr  # noqa: E402  (sets XLA_FLAGS first)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.common.params import abstract_init  # noqa: E402
from repro.configs import ASSIGNED_ARCHS, get_config, get_shapes  # noqa: E402
from repro.configs.base import GNNConfig, LMConfig  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models.gnn import driver as gnn_driver  # noqa: E402
from repro.models.recsys import xdeepfm  # noqa: E402
from repro.roofline.hlo_parse import (count_collective_ops,  # noqa: E402
                                      parse_collective_bytes)
from repro.sharding.rules import rule_overrides, shard_tree  # noqa: E402

SHARD_ROWS, SHARD_COLS = 8, 16      # one shard's block of the collectives


def init_fn(cfg, arch):
    if isinstance(cfg, LMConfig):
        return lambda k: lm.init_lm(cfg, k)
    if isinstance(cfg, GNNConfig):
        s = get_shapes(arch)[0]
        return lambda k: gnn_driver.init_model(cfg, k,
                                               s.dims.get("d_feat", 16))
    return lambda k: xdeepfm.init(cfg, k)


def is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def flat(tree, axes, prefix=""):
    """path -> (shape, dtype, axes) of every leaf."""
    out = {}
    if isinstance(tree, dict):
        for k in tree:
            out.update(flat(tree[k], axes[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, (t, a) in enumerate(zip(tree, axes)):
            out.update(flat(t, a, f"{prefix}/{i}"))
    else:
        out[prefix] = [list(tree.shape), str(tree.dtype), list(axes)]
    return out


def shard_bytes(abs_params, shardings) -> int:
    total = 0
    for leaf, sh in zip(jax.tree.leaves(abs_params),
                        jax.tree.leaves(shardings)):
        total += int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
    return total


def main(path):
    out = {"params": {}, "per_device": {}, "model_flops": {}}
    meshes = {"singlepod": make_production_mesh(multi_pod=False),
              "multipod": make_production_mesh(multi_pod=True)}
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        abs_p, axes = abstract_init(init_fn(cfg, arch), jax.random.PRNGKey(0))
        out["params"][arch] = flat(abs_p, axes)
        moments = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                             jnp.float32),
                               abs_p)
        for name, mesh in meshes.items():
            if isinstance(cfg, GNNConfig):
                sh = jax.tree.map(lambda _: NamedSharding(mesh, P()), abs_p)
                msh = sh
            else:
                with rule_overrides(getattr(cfg, "sharding_overrides", {})):
                    sh = shard_tree(axes, abs_p, mesh)
                    msh = shard_tree(axes, moments, mesh)
            out["per_device"][f"{arch}/{name}"] = {
                "params": shard_bytes(abs_p, sh),
                "opt": 2 * shard_bytes(moments, msh) + 4}
        for shape in get_shapes(arch):
            if shape.skip:
                continue
            with rule_overrides(getattr(cfg, "sharding_overrides", {})):
                _, _, meta, _ = dr.build_cell(arch, shape,
                                              meshes["singlepod"], True)
            out["model_flops"][f"{arch}/{shape.name}"] = int(
                meta["model_flops"])

    # collectives over four devices
    from jax.experimental.shard_map import shard_map
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))
    x = jnp.ones((4 * SHARD_ROWS, SHARD_COLS), jnp.float32)
    progs = {
        "psum": lambda b: jax.lax.psum(b, "data"),
        "all_gather": lambda b: jax.lax.all_gather(b, "data", tiled=True),
        "ppermute": lambda b: jax.lax.ppermute(
            b, "data", [(i, (i + 1) % 4) for i in range(4)]),
    }
    out["collectives"] = {"shard": [SHARD_ROWS, SHARD_COLS]}
    for name, body in progs.items():
        fn = jax.jit(shard_map(body, mesh=mesh4, in_specs=P("data"),
                               out_specs=P("data"), check_rep=False))
        txt = fn.lower(x).compile().as_text()
        out["collectives"][name] = {"bytes": parse_collective_bytes(txt),
                                    "ops": count_collective_ops(txt)}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
