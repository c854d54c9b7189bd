"""Kernel F's work in a traced run of a ViTDet cell
(``configs/vitdet_b_mask_rcnn.json``), and the FLOPs of the reference's
attention products.

``instrument(run)`` wraps the program's ``ops/vit_attention.py:
vit_attention`` (which ``models/vit.py`` looks up at each call) so that
each call of the window records its shape ``(BH, N, Kh, Kw)`` and, through
a hook on its output, each backward pass of it.  ``work(run)`` reduces
them into ``run.work["vit_attn"]``: the calls and their least time on the
H100 (:func:`least_seconds`), summed.  It also puts into
``run.work["vit_attn_reference_f32"]`` the FLOPs of the reference's two
attention products in one TTA step and one inference pass
(:func:`forward_flops`), which the reference counts at the float32 rate
(it computes them in float32) and the program runs on the bf16 tensor
cores: ``metrics/tta_mfu.vitdet.py`` counts them at the bf16 rate.
"""

from __future__ import annotations

from roofline import PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S

HEAD_DIM = 64


def attention_work(BH: int, N: int, Kh: int, Kw: int, backward: bool):
    """Bytes and FLOPs one call needs: the FLOPs of the two products the
    result needs, ``4 BH N^2 d`` forward and ``8 BH N^2 d`` backward (no
    recomputation counted); ``q``, ``k``, ``v``, ``o`` (and backward ``dO``,
    ``dq``, ``dk``, ``dv``) in bf16, the log-sum-exp, ``rel_h`` and
    ``rel_w`` (and backward their gradients) in float32, each once."""
    d = HEAD_DIM
    flops = (8.0 if backward else 4.0) * BH * N * N * d
    tensors = 8 if backward else 4
    rel = BH * N * (Kh + Kw) * 4 * (2 if backward else 1)
    return tensors * BH * N * d * 2 + BH * N * 4 + rel, flops


def least_seconds(BH: int, N: int, Kh: int, Kw: int, backward: bool) -> float:
    """The least time of :func:`attention_work` on the H100: bytes at
    3.35 TB/s or FLOPs at 989 TFLOP/s, whichever is longer."""
    nbytes, flops = attention_work(BH, N, Kh, Kw, backward)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOP_PER_S)


def block_shapes(cfg: dict, batch: int) -> list:
    """``(BH, N, Kh, Kw)`` of each block's attention on ``batch`` images of
    the ``SQUARE_PAD`` square: windows of the grid padded to the window
    size, or the whole grid."""
    v = cfg["MODEL"]["VIT"]
    grid = v["SQUARE_PAD"] // v["PATCH_SIZE"]
    heads, ws = v["NUM_HEADS"], v["WINDOW_SIZE"]
    out = []
    for i in range(v["DEPTH"]):
        if i in v["WINDOW_BLOCK_INDEXES"]:
            n_win = (-(-grid // ws)) ** 2
            out.append((batch * n_win * heads, ws * ws, ws, ws))
        else:
            out.append((batch * heads, grid * grid, grid, grid))
    return out


def forward_flops(cfg: dict, batch: int) -> float:
    """FLOPs of the attention's two products in one forward pass."""
    return sum(attention_work(*s, False)[1] for s in block_shapes(cfg, batch))


def instrument(run) -> None:
    from ttdg_mgm_torch.ops import vit_attention as op

    calls = run.work.setdefault("vit_attn_calls", [])
    real = op.vit_attention

    def attention(q, k, v, rel_h, rel_w, scale):
        out = real(q, k, v, rel_h, rel_w, scale)
        shape = (int(q.shape[0]), int(q.shape[1]), int(rel_h.shape[-1]), int(rel_w.shape[-1]))
        calls.append(shape + (False,))
        if out.requires_grad:
            out.register_hook(lambda grad: calls.append(shape + (True,)))
        return out

    run.recorder.replace(op, "vit_attention", attention)


def work(run) -> None:
    calls = run.work.pop("vit_attn_calls", [])
    run.work["vit_attn"] = {
        "forward": sum(1 for c in calls if not c[4]),
        "backward": sum(1 for c in calls if c[4]),
        "least_s": sum(least_seconds(*c) for c in calls),
        "flops": sum(attention_work(*c)[1] for c in calls),
    }
    f = forward_flops(run.cfg, run.cfg["TEST"]["BATCH"])
    # a TTA step: the forward and its backward (twice the forward's)
    run.work["vit_attn_reference_f32"] = {"tta_step": 3 * f, "inference": f}
