"""Runs the JAX package's mesh bodies (its ``shard_map`` programs) on four
host CPU devices and writes their inputs, initialised parameters and
outputs to an ``.npz``, for the port's parity tests
(``test_torch_mesh_ring.py``, ``test_torch_mesh_models.py``) to read.

    python tests/torch_mesh_ref.py {ring|models} OUT.npz

It sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` itself, so
it runs in a process of its own. Leaves of a tree are stored under their
'/'-joined paths (``flatten``); every program is jitted (an unjitted
``shard_map`` runs op by op, ~5x slower). A reference body that raises is
recorded as ``raises/<case>`` = its exception's type and first line.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

# the meshes of the tests: S = 2 and 4 data shards, and a (2, 2) grid. The
# reference's ring needs a "model" axis (ROADMAP.md Queue 3), so S shards
# are an (S, 1) grid over ("data", "model")
MESHES = {"s2": (2, 1), "s4": (4, 1), "g22": (2, 2)}
N_NODES, N_EDGES, D_FEAT = 64, 400, 8
RING_ARCHS = ("egnn", "nequip", "equiformer-v2")


def mesh(name):
    shape = MESHES[name]
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, ("data", "model"))


def flatten(prefix, tree, out):
    """Stores ``tree``'s leaves (numpy) under '/'-joined paths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(f"{prefix}/{k}", v, out)
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            flatten(f"{prefix}/{i}", v, out)
    elif hasattr(tree, "_fields"):                 # a NamedTuple
        for k in tree._fields:
            flatten(f"{prefix}/{k}", getattr(tree, k), out)
    else:
        out[prefix] = np.asarray(tree)


def record_raise(out, case, fn):
    try:
        fn()
    except Exception as e:                         # noqa: BLE001
        out[f"raises/{case}"] = np.array(
            f"{type(e).__name__}: {str(e).splitlines()[0]}")


def ring(out):
    from repro.configs import smoke_config
    from repro.models.gnn import dimenet
    from repro.models.gnn import driver as d
    from repro.models.gnn.common import to_ring
    from repro.train.optimizer import init_adamw

    g = d.make_flat_graph(N_NODES, N_EDGES, D_FEAT, seed=0)
    flatten("graph", g, out)
    for s in (2, 4):
        flatten(f"ring{s}", to_ring(g, s), out)
        flatten(f"ring{s}_cap", to_ring(g, s, e_cap=20), out)
        for cap in (8, 100):
            _, ts, td, tm = dimenet.build_triplet_ring(g, s, cap)
            flatten(f"tri{s}_{cap}", (ts, td, tm), out)

    def sums(x):
        return {k: np.asarray(v) for k, v in x.items()}

    for arch in RING_ARCHS:
        cfg = smoke_config(arch)
        params, _ = d.init_model(cfg, jax.random.PRNGKey(0), D_FEAT)
        flatten(f"{arch}/params", params, out)
        flatten(f"{arch}/local", sums(jax.jit(
            lambda p: d.full_graph_loss(cfg, p, g))(params)), out)
        for name, (s, _) in MESHES.items():
            m, rg = mesh(name), to_ring(g, s)
            flatten(f"{arch}/{name}", sums(jax.jit(
                lambda p, r: d.full_graph_loss(cfg, p, r, m))(params, rg)),
                out)

    # the ring's gradient and one train step (EGNN)
    cfg = smoke_config("egnn")
    params, _ = d.init_model(cfg, jax.random.PRNGKey(0), D_FEAT)
    for name in ("s4", "g22"):
        m, rg = mesh(name), to_ring(g, MESHES[name][0])

        def loss(p, r, m=m):
            out_ = d.full_graph_loss(cfg, p, r, m)
            return out_["loss_sum"] / jnp.maximum(out_["count"], 1.0)

        flatten(f"egnn/grad/{name}", jax.jit(jax.grad(loss))(params, rg),
                out)
        new, _, metrics = jax.jit(d.make_train_step(cfg, "full_graph", m))(
            params, init_adamw(params), {"graph": rg})
        flatten(f"egnn/step/{name}/params", new, out)
        flatten(f"egnn/step/{name}/metrics", metrics, out)

    # DimeNet: the local loss and the line-graph ring, at a triplet cap
    # that binds (8) and one that does not (100)
    cfg = smoke_config("dimenet")
    params, _ = d.init_model(cfg, jax.random.PRNGKey(0), D_FEAT)
    flatten("dimenet/params", params, out)
    for cap in (8, 100):
        trip = dimenet.build_triplets(np.asarray(g.edge_src),
                                      np.asarray(g.edge_dst),
                                      np.asarray(g.edge_mask), cap)
        flatten(f"dimenet/local_{cap}", sums(jax.jit(
            lambda p: d.full_graph_loss(cfg, p, g, triplets=trip))(params)),
            out)
        for name in ("s2", "g22"):
            m = mesh(name)
            rg, ts, td, tm = dimenet.build_triplet_ring(g, MESHES[name][0],
                                                        cap)
            flatten(f"dimenet/{name}_{cap}", sums(jax.jit(
                lambda p, r, a, b, c, m=m: dimenet.ring_loss(
                    cfg, p, r, a, b, c, m, d._ce_sums))(params, rg, ts, td,
                                                         tm)), out)

    # the reference's gaps: a ring over a mesh without a "model" axis, and
    # DimeNet's full_graph_loss over a mesh
    data_only = Mesh(np.array(jax.devices()[:2]), ("data",))
    record_raise(out, "data_only_ring", lambda: d.full_graph_loss(
        smoke_config("egnn"), d.init_model(smoke_config("egnn"),
                                           jax.random.PRNGKey(0), D_FEAT)[0],
        to_ring(g, 2), data_only))
    record_raise(out, "dimenet_full_graph_loss", lambda: d.full_graph_loss(
        cfg, params, to_ring(g, 2), mesh("s2")))


def models(out):
    from repro.configs import smoke_config
    from repro.layers import moe
    from repro.models import lm
    from repro.models.gnn import driver as gd
    from repro.models.recsys import embedding_bag, xdeepfm
    from repro.sharding.rules import logical_to_spec, shard_tree

    rng = np.random.default_rng(0)

    def spec_rows(sh):
        return np.array([repr(tuple(s.spec)) for s in jax.tree.leaves(
            sh, is_leaf=lambda x: hasattr(x, "spec"))])

    # shard_tree on the reference's own axes trees
    import pickle
    trees = {}
    for arch in ("phi4-mini-3.8b", "deepseek-v2-lite-16b"):
        cfg = smoke_config(arch)
        params, axes = lm.init_lm(cfg, jax.random.PRNGKey(0))
        trees[arch] = (axes, jax.tree.map(lambda a: tuple(a.shape), params))
        for name in MESHES:
            out[f"spec/{arch}/{name}"] = spec_rows(shard_tree(axes, params,
                                                              mesh(name)))
    cfg = smoke_config("egnn")
    params, axes = gd.init_model(cfg, jax.random.PRNGKey(0), D_FEAT)
    trees["egnn"] = (axes, jax.tree.map(lambda a: tuple(a.shape), params))
    for name in MESHES:
        out[f"spec/egnn/{name}"] = spec_rows(shard_tree(axes, params,
                                                        mesh(name)))
    out["spec/trees"] = np.frombuffer(pickle.dumps(trees), np.uint8)
    # the production grid's specs, resolved against its shape alone
    prod = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    axes, params = trees["deepseek-v2-lite-16b"]
    out["spec/dsv2/prod"] = np.array([
        repr(tuple(logical_to_spec(a, prod, None, s)))
        for a, s in zip(jax.tree.leaves(axes, is_leaf=lambda x: isinstance(
            x, tuple) and all(e is None or isinstance(e, str) for e in x)),
            jax.tree.leaves(params, is_leaf=lambda x: isinstance(x, tuple)
                            and all(isinstance(e, int) for e in x)))])

    # xDeepFM: the row-sharded lookup, the forward and retrieval
    cfg = smoke_config("xdeepfm")
    params = xdeepfm.init(cfg, jax.random.PRNGKey(0))[0]
    flatten("xdeepfm/params", params, out)
    ids = rng.integers(0, cfg.vocab_per_field, (16, cfg.n_sparse)).astype(
        np.int32)
    bad = ids.copy()
    bad[0, 0], bad[1, 1] = cfg.vocab_per_field + 3, -2     # out of range
    out["xdeepfm/ids"], out["xdeepfm/bad_ids"] = ids, bad
    out["xdeepfm/forward"] = np.asarray(jax.jit(
        lambda p, i: xdeepfm.forward(cfg, p, i))(params, ids))
    for name in MESHES:
        m = mesh(name)
        out[f"xdeepfm/lookup/{name}"] = np.asarray(jax.jit(
            lambda t, i: embedding_bag.lookup_sharded(t, i, m))(
                params["tables"], ids))
        out[f"xdeepfm/lookup_bad/{name}"] = np.asarray(jax.jit(
            lambda t, i: embedding_bag.lookup_sharded(t, i, m))(
                params["tables"], bad))
        out[f"xdeepfm/forward/{name}"] = np.asarray(jax.jit(
            lambda p, i: xdeepfm.forward(cfg, p, i, m))(params, ids))
        out[f"xdeepfm/retrieval/{name}"] = np.asarray(jax.jit(
            lambda p, u, c: xdeepfm.retrieval_score(cfg, p, u, c, m))(
                params, ids[0], ids))
    out["xdeepfm/lookup_bad"] = np.asarray(embedding_bag.lookup(
        params["tables"], bad))

    # the MoE FFN: outputs, aux and each data shard's keep mask (the
    # reference's ranking on the shard's tokens, at the shard's capacity)
    mcfg = smoke_config("deepseek-v2-lite-16b").replace(dtype="float32")
    mp = moe.init_moe(mcfg, jax.random.PRNGKey(1))[0]
    flatten("moe/params", mp, out)
    x = rng.normal(size=(4, 8, mcfg.d_model)).astype(np.float32)
    out["moe/x"] = x
    cf = 0.75                                      # an expert overflows
    for name, (n_data, _) in MESHES.items():
        m = mesh(name)
        y, aux = jax.jit(lambda p, xx: moe.moe_ffn(
            mcfg, p, xx, m, capacity_factor=cf))(mp, x)
        out[f"moe/{name}/out"], out[f"moe/{name}/aux"] = y, aux
        keeps = []
        for xs in np.split(x, n_data):
            xf = jnp.asarray(xs.reshape(-1, mcfg.d_model))
            t, e, k = xf.shape[0], mcfg.n_experts, mcfg.top_k
            cap = max(int(np.ceil(t * k * cf / e)), 1)
            probs = jax.nn.softmax(xf @ mp["wr"], axis=-1)
            _, idx = jax.lax.top_k(probs, k)
            oh = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t * k, e)
            pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
            keeps.append(np.asarray(pos < cap))
        out[f"moe/{name}/keep"] = np.stack(keeps)
    y, aux = jax.jit(lambda p, xx: moe.moe_ffn(mcfg, p, xx,
                                               capacity_factor=cf))(mp, x)
    out["moe/none/out"], out["moe/none/aux"] = y, aux

    # the LM (DeepSeek-V2-Lite's smoke config: MLA and MoE) over a mesh
    lcfg = smoke_config("deepseek-v2-lite-16b").replace(dtype="float32")
    lp, _ = lm.init_lm(lcfg, jax.random.PRNGKey(2))
    flatten("lm/params", lp, out)
    tokens = rng.integers(0, lcfg.vocab_size, (4, 16)).astype(np.int32)
    out["lm/tokens"] = tokens
    for name in ("g22",):
        m = mesh(name)
        logits, aux = jax.jit(lambda p, t: lm.forward(lcfg, p, t, m))(
            lp, tokens)
        out[f"lm/{name}/logits"], out[f"lm/{name}/aux"] = logits, aux
        last, cache = jax.jit(lambda p, t: lm.prefill(lcfg, p, t, m,
                                                      margin=4))(lp, tokens)
        out[f"lm/{name}/prefill"] = last
        nxt, _ = jax.jit(lambda p, c, t: lm.decode_step(
            lcfg, p, c, t, 16, m))(lp, cache, tokens[:, 0])
        out[f"lm/{name}/decode"] = nxt
    record_raise(out, "moe_data_only", lambda: moe.moe_ffn(
        mcfg, mp, x, Mesh(np.array(jax.devices()[:2]), ("data",))))


if __name__ == "__main__":
    which, path = sys.argv[1], sys.argv[2]
    results = {}
    {"ring": ring, "models": models}[which](results)
    np.savez(path, **results)
