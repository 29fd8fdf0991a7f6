"""Shared LM-family shape set (the reference's ``lm_shapes``)."""
from repro_torch.configs.base import ShapeSpec


def lm_shapes(*, long_ok: bool, long_note: str = "") -> list[ShapeSpec]:
    return [
        ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
        ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
        ShapeSpec(
            "long_500k", "decode", {"seq_len": 524288, "global_batch": 1},
            skip=not long_ok,
            skip_reason="" if long_ok else (
                long_note or "pure full-attention arch: no sub-quadratic path at 500k "
                "(skip recorded per docs/DESIGN.md §4)"),
        ),
    ]
