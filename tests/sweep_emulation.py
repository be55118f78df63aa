"""
A plain-torch emulation of K6's cluster schedule (``csrc/btd.cu``), for
the CPU tests and, on the card, as the kernel's bit-level reference.

It runs the schedule of one launch in lockstep: each CTA of the cluster
owns ``rows_per_cta`` rows of every row block, its producer fills a ring of
``ring`` slots as far ahead as the slots it has released allow, each warp
takes ``rows_per_warp`` rows of a slot and sums each row's dot product in
the kernel's order (lane ``l`` along its 16-byte chunks ``l + 32 c``, then
the xor-shuffle tree), and pushes its entries of the new carried vector
into buffer ``s & 1`` of every CTA, whose byte count must reach ``Bt x
sizeof(factor)`` before that CTA reads the buffer.  The CTAs run one after
another within a row block, so a push into the buffer another CTA still has
to read would change its result.

The products accumulate as the kernel's FMAs do where that is exact in the
emulation: bf16 factors (their products are exact in f32, so each FMA is
one f32 addition), f32 factors (products exact in f64, one f64 addition,
then rounded to f32: the same as the FMA unless that second rounding
meets a tie) and f64 factors on data whose products and sums are exact.
"""

import torch

from vf_fem_tpu_torch import ops


def _lane_sums(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dot products of ``rows`` (m, Bt) with ``x`` (Bt,), both in the
    factor type, in the kernel's order; returns (m,) in the accumulation
    type (f32 for bf16 factors)."""
    es = rows.element_size()
    vec = 16 // es
    m, bt = rows.shape
    cpr = bt // vec
    cpl = -(-cpr // 32)
    acc_t = torch.float32 if rows.dtype == torch.bfloat16 else rows.dtype
    # chunks padded to 32 lanes x cpl with zeros: adding +0 to a sum that
    # starts at +0 changes nothing
    pad = cpl * 32 * vec - bt
    a = torch.nn.functional.pad(rows.to(acc_t), (0, pad)).reshape(m, cpl, 32, vec)
    xv = torch.nn.functional.pad(x.to(acc_t), (0, pad)).reshape(cpl, 32, vec)
    acc = torch.zeros((m, 32), dtype=acc_t)
    for c in range(cpl):
        for v in range(vec):
            if rows.dtype == torch.float32:
                acc = (acc.double() + a[:, c, :, v].double() * xv[c, :, v].double()).float()
            else:
                acc = acc + a[:, c, :, v] * xv[c, :, v]
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ off]
    return acc[:, 0]


def emulate_sweep(A: torch.Tensor, g: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """K6's sweep on CPU tensors by its schedule (``ops.sweep_plan`` of the
    shapes and dtypes)."""
    n, bt = g.shape
    ftype, vtype = A.dtype, g.dtype
    p = ops.sweep_plan(bt, ftype, vtype)
    C, R, RS, SPB, NST = p.cluster, p.rows_per_cta, p.stage_rows, p.stages_per_block, p.ring
    es = A.element_size()
    assert R * C == bt and SPB * RS == R and p.rows_per_warp * es % 4 == 0
    out = torch.empty_like(g)
    xs = [[torch.zeros(bt, dtype=ftype) for _ in range(2)] for _ in range(C)]
    landed = [[0, 0] for _ in range(C)]  # bytes on each CTA's xready[b]
    ring = [[None] * NST for _ in range(C)]  # (stage, rows) in each slot
    issued, released = [0] * C, [0] * C
    for s in range(n):
        i = n - 1 - s if reverse else s
        rb = s & 1
        push = s + 1 < n
        for r in range(C):
            # the producer runs ahead into every slot released so far
            while issued[r] < min(n * SPB, released[r] + NST):
                t = issued[r]
                ss, sub = divmod(t, SPB)
                ii = n - 1 - ss if reverse else ss
                lo = r * R + sub * RS
                ring[r][t % NST] = (t, A[ii, lo:lo + RS])
                issued[r] += 1
            if s > 0:  # all of x_{i-1} has landed in this CTA, once
                assert landed[r][rb ^ 1] == bt * es, (s, r, landed[r])
                landed[r][rb ^ 1] = 0
            x = xs[r][rb ^ 1]
            for sub in range(SPB):
                t = s * SPB + sub
                tag, rows = ring[r][t % NST]
                assert tag == t, (r, t, tag)
                k0 = r * R + sub * RS
                y = g[i, k0:k0 + RS] - _lane_sums(rows, x).to(vtype)
                out[i, k0:k0 + RS] = y
                released[r] += 1
                if push:
                    yf = y.to(ftype)
                    for q in range(C):
                        xs[q][rb][k0:k0 + RS] = yf
                        landed[q][rb] += RS * es
    return out
