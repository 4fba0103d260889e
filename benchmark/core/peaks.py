"""The H100's data-sheet peaks and the operations and bytes of the kernels
that the per-layer metrics hold against them.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power limit; a run
records the card's own limit beside every share): 3.35 TB/s of HBM,
1,979 TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor
cores."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}


def k1_bound_s(n_users: int, n_items: int, width: int, operand: str) -> float:
    """The least time of one K1 launch (B @ xi and Bᵀ @ xu over the
    (U, I) 0/1 block, ``width`` output columns): each input read and each
    output written once, or 4·U·I·width operations at the peak of the
    operand precision, whichever is longer. float32 operands run as three
    bf16 products, so they count three times the operations at the bf16
    peak; outputs are int32 for int8 operands and float32 otherwise."""
    ui, rows = n_users * n_items, n_users + n_items
    if operand == "int8":
        ops, peak, in_b = 4 * ui * width, PEAK["int8"], 1
    elif operand == "bfloat16":
        ops, peak, in_b = 4 * ui * width, PEAK["bfloat16"], 2
    elif operand == "float32":
        ops, peak, in_b = 3 * 4 * ui * width, PEAK["bfloat16"], 4
    else:
        raise ValueError(f"K1 takes int8, bfloat16 or float32 operands, not {operand}")
    nbytes = ui + rows * width * in_b + rows * width * 4
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)
