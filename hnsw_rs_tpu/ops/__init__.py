"""Numeric kernel layer (device-native analogue of the reference's ``vectors``
crate): quantization, fused L2 distance kernels, and ordered (dist, id)
selection primitives."""

from .quant import BITS, LEVELS, dequantize, quantize
from .distance import (
    l2,
    normalize,
    l2sq,
    l2sq_quant,
    pairwise_l2sq_exact,
    pairwise_l2sq_mxu,
    point_normsq,
)
from .pq import adc_score, encode_pq, pq_lut, train_pq
from .topk import INF, PAD_ID, SENTINEL, dedup_ids, mask_invalid, sort_dist_id, topk_dist_id

__all__ = [
    "adc_score",
    "encode_pq",
    "pq_lut",
    "train_pq",
    "BITS",
    "LEVELS",
    "INF",
    "PAD_ID",
    "SENTINEL",
    "quantize",
    "dequantize",
    "l2",
    "normalize",
    "l2sq",
    "l2sq_quant",
    "pairwise_l2sq_exact",
    "pairwise_l2sq_mxu",
    "point_normsq",
    "sort_dist_id",
    "topk_dist_id",
    "mask_invalid",
    "dedup_ids",
]
