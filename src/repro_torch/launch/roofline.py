"""Roofline terms of a dry-run cell on the H100, and the operation counts
of the port's kernels: a port of ``src/repro/launch/roofline.py``.

    compute term    = flops / peak FLOP/s
    memory term     = hbm_bytes / HBM rate
    collective term = collective_bytes / link rate

all per device.  The reference reads its flops and bytes from XLA's cost
analysis and its collectives from the optimized HLO; the port has neither.
Its dry run (:mod:`repro_torch.launch.dryrun`) counts flops with
``torch.utils.flop_counter.FlopCounterMode`` over the traced step (the
kernels' fake versions carry the formulas below) and bytes over every
traced aten op's tensors, and :func:`collectives_from_specs` counts the
collectives that the sharding rules imply for FSDP.

The counts of the kernels' work (:func:`valid_pairs`, :func:`flash_ops`,
:func:`flash_bwd_ops`, :func:`ssd_ops_needed`, :func:`ssd_bwd_ops_needed`,
:func:`ssd_bwd_kernel_ops`) are the ones ``chip_smoke.py`` takes for its
bounds, so one count serves both.  This module imports numpy only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: H100 SXM data sheet, dense bf16 on the tensor cores and the HBM3 rate
#: (``cost/model.py`` takes the same)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
#: NVLink 4 within an 8-card HGX H100 node: 900 GB/s a card both ways,
#: 450 GB/s a direction (NVIDIA's H100 SXM data sheet)
NVLINK_BW = 450e9
#: across nodes, one 400 Gb/s NDR InfiniBand adapter a card (the DGX H100
#: layout): ~50 GB/s a direction
INFINIBAND_BW = 50e9
#: cards a node, joined all to all by NVLink
NODE_CARDS = 8

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    hbm_bytes: float  # per device, bytes accessed
    collective_bytes: float  # per device
    chips: int
    link_bw: float = INFINIBAND_BW  # bytes/s of the slowest link the collectives cross

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "link_bw": self.link_bw,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D analytic model FLOPs for one training step."""
    return 6.0 * cfg.active_param_count() * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    """2·N_active per generated token (forward only)."""
    return 2.0 * cfg.active_param_count() * tokens


# ---------------------------------------------------------------------------
# collectives implied by the sharding rules
# ---------------------------------------------------------------------------


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def link_bw_for(mesh, axes) -> float:
    """The link rate of a collective over ``axes``: NVLink where every
    group it runs over lies within one node (the mesh's positions laid
    out in order, the last axis fastest, :data:`NODE_CARDS` to a node),
    InfiniBand where a group spans nodes."""
    names = list(mesh.shape)
    if not axes:
        return NVLINK_BW
    first = min(names.index(a) for a in axes)
    span = int(np.prod([mesh.shape[a] for a in names[first:]]))
    return NVLINK_BW if span <= NODE_CARDS else INFINIBAND_BW


def collectives_from_specs(leaves, specs, mesh, *, uses: int, reduce_grads: bool
                           ) -> tuple[CollectiveStats, float]:
    """The FSDP collectives of one step, per device: each parameter leaf
    sharded over data axes (its spec names ``data`` or ``pod``) is
    all-gathered in bf16 (2 bytes an element; 1-D leaves are replicated by
    the rules) at (n - 1) / n of its bytes, n the product of those axes'
    sizes, ``uses`` times; with ``reduce_grads`` its float32 gradient is
    reduce-scattered once, at (n - 1) / n of its bytes.  A leaf's bytes are
    those of its slice on one device along every other axis it is sharded
    over (``model``).  ``leaves`` and ``specs`` are matching lists.  The
    collectives of tensor parallelism over ``model`` (the activations'
    all-reduces) are not counted.  Returns the stats and the link rate of
    the slowest link those collectives cross."""
    bytes_by = {k: 0.0 for k in COLLECTIVE_KINDS}
    count_by = {k: 0 for k in COLLECTIVE_KINDS}
    data_axes = set()
    for leaf, spec in zip(leaves, specs):
        axes = [a for e in spec for a in _axes_of(e)]
        fsdp = [a for a in axes if a in ("pod", "data")]
        if not fsdp:
            continue
        n = int(np.prod([mesh.shape[a] for a in fsdp]))
        other = int(np.prod([mesh.shape[a] for a in axes if a not in fsdp]))
        numel = int(np.prod(leaf.shape)) // other
        share = (n - 1) / n
        data_axes.update(fsdp)
        bytes_by["all-gather"] += uses * 2 * numel * share
        count_by["all-gather"] += uses
        if reduce_grads:
            bytes_by["reduce-scatter"] += 4 * numel * share
            count_by["reduce-scatter"] += 1
    return CollectiveStats(bytes_by, count_by), link_bw_for(mesh, tuple(data_axes))


# ---------------------------------------------------------------------------
# the kernels' work
# ---------------------------------------------------------------------------


def valid_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs the attention mask lets through, per (b, head)."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_ops(B: int, Hq: int, Sq: int, Sk: int, D: int, causal: bool = True,
              window=None, q_offset: int = 0) -> int:
    """flash_attention's forward: q.k and p.v, 2 D operations each, per
    (query, key) pair the mask lets through, over B x Hq."""
    return 4 * D * valid_pairs(Sq, Sk, causal, window, q_offset) * B * Hq


def flash_bwd_ops(B: int, Hq: int, Sq: int, Sk: int, D: int, causal: bool = True,
                  window=None, q_offset: int = 0) -> int:
    """flash_attention's backward: 5 products of 2 D operations per valid
    pair (S = q.k recomputed, dP = dO.v, dV += P^T dO, dK += dS^T q, dQ +=
    dS k), 2.5 times the forward.  The kernels compute 7 (S and dP in both
    the dK/dV and the dQ pass); this is the function's own count."""
    return 5 * 2 * D * valid_pairs(Sq, Sk, causal, window, q_offset) * B * Hq


def ssd_ops_needed(BH: int, BG: int, L: int, P: int, N: int, Q: int) -> int:
    """Operations of the chunked form at chunk Q on this data: per chunk of
    r rows, the lower triangle of C B^T (r(r+1)/2 N multiply-adds) once per
    group, since it does not depend on the head; per head, that triangle's
    product with xdt (r(r+1)/2 P), C S for every chunk after the first
    (r N P) and the state update for every chunk but the last (r N P).
    It grows with Q; at Q = 1 it is the recurrence's own work."""
    per_group = per_head = 0
    for c, c0 in enumerate(range(0, L, Q)):
        r = min(Q, L - c0)
        tri = r * (r + 1) // 2
        per_group += tri * N
        per_head += tri * P
        if c > 0:
            per_head += r * N * P
        if c0 + Q < L:
            per_head += r * N * P
    return 2 * (per_group * BG + per_head * BH)


def ssd_bwd_ops_needed(BH: int, L: int, P: int, N: int) -> int:
    """Operations of ssd_scan's backward at chunk 1, the reverse
    recurrence: per row and head, G_t = C_t dy_t^T + exp(dtA_{t+1}) G_{t+1},
    dxdt_t = G_t^T B_t, dB_t = G_t xdt_t, dC_t = S_t dy_t and the forward
    state S_t recomputed alongside, each N P multiply-adds: 10 N P
    operations, 2.5x the forward's 4 N P (dB and dC summed over a group's
    heads inside those multiply-adds).  ddtA_t = exp(dtA_t) <G_t, S_{t-1}>
    needs no N P term of its own: <G_t, S_t> is both ddtA_t + xdt_t . dxdt_t
    and dy_t . y_t + ddtA_{t+1}, so ddtA is the reverse cumsum of
    dy_t . y_t - xdt_t . dxdt_t, O(P) a row with y the forward's output."""
    return 10 * N * P * L * BH


def ssd_bwd_kernel_ops(BH: int, BG: int, L: int, P: int, N: int, Q: int,
                       slices: int) -> int:
    """Operations of ssd_scan's backward kernels at chunk Q, counted as
    :func:`ssd_ops_needed` counts the forward's: the products of the
    chunked backward on this data, two operations a multiply-add, the
    elementwise terms (exponentials, masks, the state pass's decay and
    <g_c, S_in[c + 1]>, the row terms dy . y - xdt . dxdt) not counted.
    Per chunk of r rows (tri = r(r+1)/2), per head: dS_in = sum_i C_i dy_i^T
    for every chunk after the first (r N P, ``ssd_bwd_dstate``); dxdt from
    the scores C B^T read back (tri P) and from g_c for every chunk but the
    last (r N P, ``ssd_bwd_chunk_dx``); D = dy xdt^T on the triangle (tri
    P), dC's state term dy S_in^T after the first chunk and dB's xdt g_c^T
    before the last (r N P each, ``ssd_bwd_chunk_dbc``).  Per group and
    slice of its heads (``slices``, the binding's ``bwd_slices``): the
    slice's summed D against B and C for dC and dB (2 tri N).  The
    kernels read the forward's states instead of recomputing them, so at
    Q = 1 this is 8 N P a row and head against the reverse recurrence's 10
    (:func:`ssd_bwd_ops_needed`)."""
    per_slice = per_head = 0
    for c, c0 in enumerate(range(0, L, Q)):
        r = min(Q, L - c0)
        tri = r * (r + 1) // 2
        per_slice += 2 * tri * N
        per_head += 2 * tri * P
        if c > 0:
            per_head += 2 * r * N * P
        if c0 + Q < L:
            per_head += 2 * r * N * P
    return 2 * (per_slice * BG * slices + per_head * BH)
