"""Coverage reduction: the batch merge and the lane OR-reduce family.

The counterpart of wtf_tpu/meshrun/reduce.py.  Lane bitmaps OR into the
campaign aggregates, and a lane earns new-coverage credit the way the
reference master's SEQUENTIAL set-union merge gives it
(server.h:816-854) — only for bits that are neither in the aggregate nor
already contributed by an earlier lane of the batch.  Without the prefix
rule every lane that finds the same new edge would enter the corpus.

  merge_coverage     the single-device merge (`_merge_core` over all
                     lanes); `first_hit_credit` keeps the per-lane credit
                     planes of the same scan for triage's distillation
                     (wtf_tpu_torch/triage/replay.py)
  or_reduce_lanes    the OR of [L, W] bitmaps over the lane axis
  bitplane_or        the OR of per-shard [W] bitmaps across the mesh
  make_mesh_merge    the merge over a lane mesh: per shard the same
                     `_merge_core` on its lanes, the cross-shard exclusive
                     prefix from ONE all-gather of the per-shard unions
                     ([shards, cov_w + edge_w] words: the only bytes that
                     cross shards per batch merge); bit-identical to
                     `merge_coverage` for any lane order

Every cross-shard step is one all-gather of tiny per-shard vectors
(`gather_shards`) followed by a local OR: shards of one process stack
onto the first shard's device; across processes the stack goes through
`torch.distributed.all_gather` on host tensors (gloo gathers CPU tensors
only).  Bitmap words are int32 holding u32 bits.
"""

from __future__ import annotations

from typing import List

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


def first_hit_credit(agg_cov, agg_edge, cov, edge, include):
    """Exact per-lane coverage attribution under replay order (the device
    half of triage's corpus distillation): the same exclusive-prefix scan
    as `_merge_core`, keeping the per-lane credit planes instead of
    collapsing them to flags.  Lane i is credited exactly the bits it is
    first to set — not in `agg_*` (earlier batches) and not contributed by
    an earlier lane of this batch.  Excluded lanes (timeouts, overlay-full)
    contribute and receive nothing, the batch merge's revocation rule.

    Returns (credit_cov [L, Wc], credit_edge [L, We], agg_cov', agg_edge');
    OR-ing the credits of a whole sweep reproduces the aggregate delta.
    Words are int32 holding u32 bits (`&`, `|`, `~` act on the bits)."""
    inc = include[:, None]
    cov_in = torch.where(inc, cov, torch.zeros_like(cov))
    edge_in = torch.where(inc, edge, torch.zeros_like(edge))
    cum_cov, before_cov = _prefix_scan(cov_in, agg_cov)
    cum_edge, before_edge = _prefix_scan(edge_in, agg_edge)
    return (cov_in & ~before_cov, edge_in & ~before_edge,
            agg_cov | cum_cov[-1], agg_edge | cum_edge[-1])


def or_reduce_lanes(words: torch.Tensor) -> torch.Tensor:
    """OR of `words` [L, ...] over its leading (lane) axis, in log2(L)
    halving folds (torch has no bitwise-or reduction)."""
    x = words
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        top = x[:half] | x[half:2 * half]
        x = torch.cat([top, x[2 * half:]]) if x.shape[0] % 2 else top
    if x.shape[0] == 0:
        return torch.zeros(words.shape[1:], dtype=words.dtype,
                           device=words.device)
    return x[0]


def merged_coverage(machine):
    """(cov, edge): the batch-wide union of the lanes' bitmaps."""
    return or_reduce_lanes(machine.cov), or_reduce_lanes(machine.edge)


def gather_shards(parts: List[torch.Tensor], mesh) -> torch.Tensor:
    """Every shard's tensor of the mesh, stacked in global shard order on
    this process's first shard's device: the all-gather of the mesh."""
    from wtf_tpu_torch.meshrun.mesh import gather_processes

    dev = mesh.devices[0]
    return gather_processes(torch.stack([p.to(dev) for p in parts]), mesh)


def bitplane_or(parts: List[torch.Tensor], mesh) -> torch.Tensor:
    """Cross-shard OR of per-shard [W] bitmaps: one all-gather, then a
    local OR (on the first shard's device)."""
    return or_reduce_lanes(gather_shards(parts, mesh))


def _shard_union(cov, edge, include) -> torch.Tensor:
    """[Wc + We]: the union of a shard's included lanes' bitmaps."""
    inc = include[:, None]
    return or_reduce_lanes(torch.cat(
        [torch.where(inc, cov, torch.zeros_like(cov)),
         torch.where(inc, edge, torch.zeros_like(edge))], dim=1))


def mesh_merge_local(agg_cov, agg_edge, cov, edge, include,
                     unions: torch.Tensor, shard: int):
    """The per-shard body of the mesh merge, given `unions` [S, Wc + We]
    (every shard's included union, gathered in global shard order) and
    this shard's global index: the shard-local prefix credit through
    `_merge_core`, seeded with the OR of the LOWER shards' unions.
    Returns (agg_cov', agg_edge', new_lane for the shard's lanes,
    new_cov_words) — the aggregates equal on every shard."""
    inc = include[:, None]
    cov_in = torch.where(inc, cov, torch.zeros_like(cov))
    edge_in = torch.where(inc, edge, torch.zeros_like(edge))
    wc = cov.shape[1]
    prev = or_reduce_lanes(unions[:shard])
    union = or_reduce_lanes(unions)
    _, _, new_lane = _merge_core(agg_cov, agg_edge, cov_in, edge_in,
                                 prev[:wc], prev[wc:])
    return (agg_cov | union[:wc], agg_edge | union[wc:], new_lane & include,
            union[:wc] & ~agg_cov)


def make_mesh_merge(mesh):
    """The batch merge over a lane mesh: a callable (agg_cov, agg_edge,
    covs, edges, includes) -> (agg_cov', agg_edge', new_lanes,
    new_cov_words), with the per-shard planes and include masks as
    lists in shard order and `new_lanes` a list likewise; the aggregates
    come back on the first shard's device."""
    from wtf_tpu_torch.meshrun.mesh import replicate

    def merge(agg_cov, agg_edge, covs, edges, includes):
        unions = gather_shards([_shard_union(c, e, i) for c, e, i in zip(
            covs, edges, includes)], mesh)
        rep = replicate((agg_cov, agg_edge, unions), mesh)
        outs = []
        for k, (c, e, i) in enumerate(zip(covs, edges, includes)):
            ac, ae, u = rep[c.device]
            outs.append(mesh_merge_local(ac, ae, c, e, i, u,
                                         mesh.first_shard + k))
        agg_c, agg_e, _, new_words = outs[0]
        return agg_c, agg_e, [o[2] for o in outs], new_words

    return merge
