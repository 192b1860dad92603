"""The batch coverage merge (single device).

The counterpart of the single-device half of wtf_tpu/meshrun/reduce.py
(`_prefix_scan`, `_merge_core`, `merge_coverage`): lane bitmaps OR into
the campaign aggregates, and a lane earns new-coverage credit the way the
reference master's SEQUENTIAL set-union merge gives it (server.h:816-854)
— only for bits that are neither in the aggregate nor already contributed
by an earlier lane of the batch.  Without the prefix rule every lane that
finds the same new edge would enter the corpus.
"""

from __future__ import annotations

import torch


def _prefix_scan(x_in: torch.Tensor, prev: torch.Tensor):
    """(inclusive cumulative OR, exclusive-prefix OR seeded with `prev`)
    over the lane axis, in log2(L) doubling steps."""
    cum = x_in.clone()
    shift = 1
    while shift < cum.shape[0]:
        cum[shift:] = cum[shift:] | cum[:-shift]
        shift *= 2
    before = torch.cat([prev[None], prev[None] | cum[:-1]], dim=0)
    return cum, before


def _merge_core(agg_cov, agg_edge, cov_in, edge_in, prev_cov, prev_edge):
    """Prefix-credit merge of one lane block given the OR of every earlier
    lane -> (block cov union, block edge union, new_lane flags)."""
    cum_cov, before_cov = _prefix_scan(cov_in, prev_cov)
    cum_edge, before_edge = _prefix_scan(edge_in, prev_edge)
    new_lane = (((cov_in & ~agg_cov[None] & ~before_cov) != 0).any(1)
                | ((edge_in & ~agg_edge[None] & ~before_edge) != 0).any(1))
    return cum_cov[-1], cum_edge[-1], new_lane


def merge_coverage(agg_cov, agg_edge, cov, edge, include):
    """OR the included lanes' bitmaps into the aggregates -> (agg_cov',
    agg_edge', new_lane, new_cov_words).  Bitmap words are int32 holding
    u32 bits."""
    inc = include[:, None]
    cov_in = torch.where(inc, cov, torch.zeros_like(cov))
    edge_in = torch.where(inc, edge, torch.zeros_like(edge))
    cov_union, edge_union, new_lane = _merge_core(
        agg_cov, agg_edge, cov_in, edge_in, torch.zeros_like(agg_cov),
        torch.zeros_like(agg_edge))
    new_cov_words = cov_union & ~agg_cov
    return (agg_cov | cov_union, agg_edge | edge_union, new_lane & include,
            new_cov_words)
