"""The least time of one launch of kernel K2 (``selfrec_tpu_torch/csrc/
ell_gather.cu``), held against the H100's peaks of
:mod:`benchmark.core.peaks`.

A launch propagates P passes of width D over one row-split ELL layout of
V virtual rows of K slots: ``out[r] = sum of w[p, v, k] * x[vidx[v, k]]``
over the virtual rows v of row r. Its compulsory bytes: ``vidx`` (V·K
int32), the weights (P·V·K f32), each source row of ``x`` read once
(P·D values of the rows' dtype), the output written once (P·D f32 a row)
and the long rows' partials written and read once (P·D f32 a slot). Its
operations: a multiply and an add a slot a column, 2·V·K·P·D, at the f32
peak outside the tensor cores."""

from __future__ import annotations

from typing import NamedTuple

from benchmark.core.peaks import HBM_BYTES_PER_S, PEAK

ROW_BYTES = {"float32": 4, "bfloat16": 2}


class K2Call(NamedTuple):
    """One call of ``ell_gather_sum`` as the ELL family records it."""

    v: int          # virtual rows
    k: int          # slots a virtual row
    p: int          # passes packed side by side
    d: int          # width of a pass
    dtype: str      # the rows' dtype, "float32" or "bfloat16"
    n_rows: int     # output rows
    n_src: int      # source rows the layout reads
    n_slots: int    # the long rows' partial slots
    capturing: bool  # recorded while a step graph was being captured


def k2_bytes(c: K2Call) -> int:
    if c.dtype not in ROW_BYTES:
        raise ValueError(f"K2 takes float32 or bfloat16 rows, not {c.dtype}")
    width = c.p * c.d
    return (c.v * c.k * 4 + c.p * c.v * c.k * 4 + c.n_src * width * ROW_BYTES[c.dtype]
            + c.n_rows * width * 4 + 2 * c.n_slots * width * 4)


def k2_bound_s(c: K2Call) -> float:
    """The larger of the compulsory bytes over the HBM's rate and the
    operations over the f32 peak."""
    return max(k2_bytes(c) / HBM_BYTES_PER_S, 2 * c.v * c.k * c.p * c.d / PEAK["float32"])
