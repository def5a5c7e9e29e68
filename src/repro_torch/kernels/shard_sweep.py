"""Band-local compute for the row-band sharded lattice.

Counterpart of ``repro.kernels.shard_sweep``.  The sharded engine
(`core/distributed.py::ShardedEngine`) cuts the Chimera cell grid into
contiguous row bands; each band owns a padded (B, n_loc) spin block plus
the (D, n_loc) slice of the slot tables, and the only spins of other bands
a half-sweep reads are the chain-coupler boundary spins of its two row
neighbours — the ``halo_up`` / ``halo_dn`` blocks.  On one card every band
lives on the same device, with a leading band axis:

  * `halo_exchange` is an index gather over the band axis (edge bands
    receive zeros, as the open lattice boundary has no couplers there).
  * `halo_half_sweep` is `kernels/ref.py::sparse_neuron_input` +
    `field_decision_update` on the extended gather source ``[local |
    halo_up | halo_dn]`` for every band at once — the same terms in the
    same order, so a sharded half-sweep equals the single-device one bit
    for bit.
  * `fused_shard_sweeps` runs one band's launch through K1
    (`sweep_sparse`; with a next program, K4) on the extended block: halo
    columns frozen (out of the update masks), counter noise at the band's
    global (chain, node) coordinates through ``coord_offset``.
  * `fused_shard_exchange_resident` runs every band's launch through K5
    (`sweep_sparse_exchange`), which refreshes the halo columns inside the
    launch at every exchange point; the engine prepares a call's launch
    once (`exchange_tables`, an `ExchangeTables`) and launches through
    `exchange_launch` on the extended block it keeps between launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import field_decision_update, sparse_neuron_input
from repro_torch.kernels.sweep_fused import (
    ExchangeTables,
    sweep_sparse,
    sweep_sparse_exchange,
    sweep_sparse_stream,
)


def halo_exchange(m_loc: torch.Tensor, send_up: torch.Tensor,
                  send_dn: torch.Tensor, comm=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every band's halos from its row neighbours' boundary spins.

    m_loc: (R, B, n_loc) spins; send_up / send_dn: (R, H) local columns of
    the vertical nodes in each band's first / last cell row (padded with 0
    — padding halo slots are never referenced by a neighbour table).
    Returns (halo_up, halo_dn), each (R, B, H): the last row of the band
    above and the first row of the band below; zeros at the edges.

    ``comm`` (a `core.ranks.RankComm`): the bands are one rank's run of a
    rank mesh.  Within the rank the halos are the same gather; the first
    band's ``halo_up`` and the last band's ``halo_dn`` are the neighbouring
    ranks' boundary rows, swapped in one ``batch_isend_irecv``
    (`RankComm.swap_edges`; zeros past the lattice's edge).
    """
    R, B, _ = m_loc.shape
    H = send_up.shape[1]
    last = m_loc.gather(2, send_dn[:, None, :].expand(R, B, H))
    first = m_loc.gather(2, send_up[:, None, :].expand(R, B, H))
    if comm is None:
        up0 = dn1 = m_loc.new_zeros((B, H))
    else:
        up0, dn1 = comm.swap_edges(first[0], last[-1])
    return (torch.cat([up0[None], last[:-1]]),
            torch.cat([first[1:], dn1[None]]))


def halo_neuron_input(m_loc, halo_up, halo_dn, nbr_idx, nbr_w, h):
    """Eqn 1 on every band's slot tables: I = Σ_d w_d ⊙ m_ext[:, idx_d] + h.

    nbr_idx: (R, D, n_loc) indices into the extended block ``[local |
    halo_up | halo_dn]``; nbr_w: (R, D, n_loc); h: (R, n_loc).  Ascending
    d from zero, ``+ h`` last — `kernels/ref.py::sparse_neuron_input`'s
    order.
    """
    m_ext = torch.cat([m_loc, halo_up, halo_dn], dim=2)
    R, B, n_loc = m_loc.shape
    acc = torch.zeros((R, B, n_loc), dtype=torch.float32,
                      device=m_loc.device)
    for d in range(nbr_idx.shape[1]):
        src = m_ext.gather(2, nbr_idx[:, d][:, None, :].expand(R, B, n_loc))
        acc = acc + nbr_w[:, d][:, None, :] * src
    return acc + h[:, None, :]


def halo_half_sweep(m_loc, halo_up, halo_dn, nbr_idx, nbr_w, h, gain, off,
                    rand_gain, comp_off, update_mask, beta, u):
    """The sparse half-sweep of every band on its extended gather source.

    m_loc/u: (R, B, n_loc); gain/off/rand_gain/comp_off/update_mask:
    (R, n_loc) (padding columns out of the mask); beta: scalar or (B,)
    per-chain inverse temperature.  The decision tail is the shared
    `kernels/ref.py::field_decision_update`.
    """
    I = halo_neuron_input(m_loc, halo_up, halo_dn, nbr_idx, nbr_w, h)
    return field_decision_update(
        m_loc, I, gain[:, None, :], off[:, None, :], rand_gain[:, None, :],
        comp_off[:, None, :], update_mask[:, None, :], beta, u)


def _extend(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero columns appended on the last axis (the halo columns' rows)."""
    return torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)


def _extended(pad, nbr_idx, nbr_w, rows, masks, clamp_mask, clamp_values):
    """A launch's operands on the extended block: the halo columns get
    zero-weight table slots, zero rows and no update or clamp (so they are
    never written)."""
    ext = dict(idx=_extend(nbr_idx.to(torch.int32), pad),
               w=_extend(nbr_w.to(torch.float32), pad),
               rows=[_extend(x.to(torch.float32), pad) for x in rows],
               masks=[_extend(mk.to(torch.bool), pad) for mk in masks],
               cm=None, cv=None)
    if clamp_mask is not None and clamp_values is not None:
        ext.update(cm=_extend(clamp_mask.to(torch.bool), pad),
                   cv=_extend(clamp_values.to(torch.float32), pad))
    return ext


def _betas(betas, B, device) -> torch.Tensor:
    betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
    if betas.ndim == 1:
        betas = betas[:, None].expand(betas.shape[0], B)
    return betas.contiguous()


def fused_shard_sweeps(
    m_loc: torch.Tensor,          # (B, n_loc) one band's spins
    halo_up: torch.Tensor,        # (B, H) frozen for the whole launch
    halo_dn: torch.Tensor,        # (B, H)
    nbr_idx: torch.Tensor,        # (D, n_loc) int32 ext-local table
    nbr_w: torch.Tensor,          # (D, n_loc)
    h, gain, off, rand_gain, comp_off,   # (n_loc,) rows
    mask0: torch.Tensor,          # (n_loc,) bool colour-0 update set
    mask1: torch.Tensor,
    betas,                        # (S,) or (S, B)
    noise_state: torch.Tensor,    # (2,) counter state
    row0: int,                    # global id of the band's chain 0
    col0: int,                    # global id of the band's node 0
    clamp_mask=None,              # (n_loc,) bool
    clamp_values=None,            # (B, n_loc)
    measured=None,                # (S,) moment weights
    next_nbr_w=None,              # (D, n_loc) next program's slots
    next_h=None,                  # (n_loc,) next program's biases
    *,
    block_b: int | None = None,
    half_offset: int = 0,
    n_half: int | None = None,
):
    """One band's sweep-resident launch on its halo-extended block.

    S sweeps (or the half-sweep window ``[half_offset, half_offset +
    n_half)``) in one K1 launch: halo columns ride in the extended block
    but stay out of the update masks, so they keep their launch-boundary
    values; counter noise at the band's global coordinates.  With
    ``next_nbr_w`` / ``next_h`` the launch is K4, staging the next
    program (no moments then).

    Returns (m', noise_state'), with ``measured`` (m', noise_state',
    s_sum[n_loc], c_slots[D, N_ext]) — raw sums over (chains x measured
    sweeps), ``c_slots[d, i] = Σ m_i·m_ext[idx[d, i]]`` with i ext-local —
    or, with a next program, (m', noise_state', staged_w[D, n_loc],
    staged_h[n_loc]).
    """
    B, n_loc = m_loc.shape
    pad = 2 * halo_up.shape[1]
    m_ext = torch.cat([m_loc, halo_up, halo_dn], dim=1)
    e = _extended(pad, nbr_idx, nbr_w, (h, gain, off, rand_gain, comp_off),
                  (mask0, mask1), clamp_mask, clamp_values)
    betas = _betas(betas, B, m_loc.device)
    coords = (int(row0), int(col0))
    if next_nbr_w is not None:
        if measured is not None:
            raise ValueError(
                "program streaming excludes in-kernel moment accumulation "
                "(see sweep_sparse_stream)")
        m_out, ns, staged_w, staged_h = sweep_sparse_stream(
            m_ext, e["idx"], e["w"], *e["rows"], *e["masks"], betas,
            noise_state, _extend(next_nbr_w.to(torch.float32), pad),
            _extend(next_h.to(torch.float32), pad), e["cm"], e["cv"],
            coords, block_b=block_b, half_offset=half_offset, n_half=n_half)
        return (m_out[:, :n_loc], ns, staged_w[:, :n_loc],
                staged_h[:n_loc])
    outs = sweep_sparse(
        m_ext, e["idx"], e["w"], *e["rows"], *e["masks"], betas, noise_state,
        e["cm"], e["cv"], measured, None, coords, noise_mode="counter",
        accumulate=measured is not None, block_b=block_b,
        half_offset=half_offset, n_half=n_half)
    m_out = outs[0][:, :n_loc]
    if measured is None:
        return m_out, outs[1]
    return m_out, outs[1], outs[2][:n_loc], outs[3]


def exchange_tables(nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off,
                    mask0, mask1, col0, send_up, send_dn, clamp_mask=None,
                    clamp_values=None, *, chains: int, ex_pts,
                    mode: str = "barrier", stream: bool = False,
                    block_b: int | None = None,
                    edge_halos: str = "zero") -> ExchangeTables:
    """The prepared launch every K5 launch of one call shares (arguments as
    `fused_shard_exchange_resident`'s; ``chains`` per band): the tables
    extended to the halo columns, the send lists as int32, each band's
    column 0, the exchange points, mode and edge halos, and the plan,
    update lists and node tables of `ExchangeTables`."""
    pad = 2 * send_up.shape[1]
    e = _extended(pad, nbr_idx, nbr_w, (h, gain, off, rand_gain, comp_off),
                  (mask0, mask1), clamp_mask, clamp_values)
    return ExchangeTables(
        e["idx"], e["w"], *e["rows"], *e["masks"],
        send_up.to(torch.int32).contiguous(),
        send_dn.to(torch.int32).contiguous(), e["cm"], e["cv"],
        chains=chains, n_loc=nbr_idx.shape[2], halo=send_up.shape[1],
        ex_pts=ex_pts, mode=mode, col0=col0, stream=stream, block_b=block_b,
        edge_halos=edge_halos)


def exchange_launch(m_ext, tables: ExchangeTables, betas, noise_state,
                    row0: int, measured=None, next_nbr_w=None, next_h=None):
    """One K5 launch of every band on prepared tables: the extended block
    ``m_ext`` (R, B, N_ext) = ``[local | halo_up | halo_dn]`` in, the
    kernel's outputs back — ``(m_ext', noise_state')``, then with
    ``measured`` ``(s_sum[R, N_ext], c_slots[R, D, N_ext])`` or, with a next
    program (R, D, n_loc) / (R, n_loc), the staged pair on the extended
    block.  The halo columns of ``m_ext'`` are as the kernel left them:
    barrier, the last installed exchange; async, the drained last
    exchange, the next launch's first halo.  A caller that launches many
    times keeps ``m_ext`` between launches and slices it once."""
    t = tables
    pad = 2 * t.halo
    nw_e = nh_e = None
    if next_nbr_w is not None:
        nw_e = _extend(next_nbr_w.to(torch.float32), pad)
        nh_e = _extend(next_h.to(torch.float32), pad)
    return sweep_sparse_exchange(
        m_ext, t.idx, t.w, *t.rows, *t.masks,
        _betas(betas, m_ext.shape[1], m_ext.device), noise_state, t.send_up,
        t.send_dn, t.clamp_mask, t.clamp_values, measured, (int(row0), t.col0),
        nw_e, nh_e, n_loc=t.n_loc, halo=t.halo, ex_pts=t.ex_pts, mode=t.mode,
        prepared=t, edge_halos=t.edge_halos)


def fused_shard_exchange_resident(
    m_loc: torch.Tensor,          # (R, B, n_loc) every band's spins
    halo_up: torch.Tensor,        # (R, B, H) halos before the launch
    halo_dn: torch.Tensor,        # (R, B, H)
    nbr_idx: torch.Tensor,        # (R, D, n_loc) int32 ext-local tables
    nbr_w: torch.Tensor,          # (R, D, n_loc)
    h, gain, off, rand_gain, comp_off,   # (R, n_loc) rows
    mask0: torch.Tensor,          # (R, n_loc) bool
    mask1: torch.Tensor,
    betas,                        # (S,) or (S, B)
    noise_state: torch.Tensor,    # (2,) counter state
    row0: int,                    # global id of chain 0
    col0,                         # (R,) global id of each band's node 0
    send_up: torch.Tensor,        # (R, H) first-row columns
    send_dn: torch.Tensor,        # (R, H) last-row columns
    clamp_mask=None,              # (R, n_loc) bool
    clamp_values=None,            # (R, B, n_loc)
    measured=None,                # (S,)
    next_nbr_w=None,              # (R, D, n_loc)
    next_h=None,                  # (R, n_loc)
    *,
    ex_pts: tuple,
    mode: str = "barrier",
    block_b: int | None = None,
    edge_halos: str = "zero",
):
    """`fused_shard_sweeps` for every band in ONE launch, with the halo
    exchange inside it (K5, `sweep_sparse_exchange`): identical noise
    counters and exchange-point staleness to the engine's emulation
    (half-sweep windows of `fused_shard_sweeps` with an exchange between
    them).  A caller launching many times prepares the tables once
    (`exchange_tables`) and calls `exchange_launch`.  ``edge_halos="block"``
    keeps the first band's ``halo_up`` and the last band's ``halo_dn`` as
    given (a rank's bands between two exchanges with its neighbours).

    Returns (m', noise_state', halo_up', halo_dn') — the halo columns as
    the kernel left them: barrier, the last installed exchange; async, the
    drained last exchange, the next launch's first halo — then, with
    ``measured``, (s_sum[R, n_loc], c_slots[R, D, N_ext]) or, with a next
    program, (staged_w[R, D, n_loc], staged_h[R, n_loc]).
    """
    R, B, n_loc = m_loc.shape
    H = halo_up.shape[2]
    tables = exchange_tables(nbr_idx, nbr_w, h, gain, off, rand_gain,
                             comp_off, mask0, mask1, col0, send_up, send_dn,
                             clamp_mask, clamp_values, chains=B,
                             ex_pts=ex_pts, mode=mode,
                             stream=next_nbr_w is not None, block_b=block_b,
                             edge_halos=edge_halos)
    outs = exchange_launch(torch.cat([m_loc, halo_up, halo_dn], dim=2),
                           tables, betas, noise_state, row0, measured,
                           next_nbr_w, next_h)
    m_out = outs[0]
    head = (m_out[:, :, :n_loc], outs[1], m_out[:, :, n_loc:n_loc + H],
            m_out[:, :, n_loc + H:])
    if measured is not None:
        return head + (outs[2][:, :n_loc], outs[3])
    if next_nbr_w is not None:
        return head + (outs[2][:, :, :n_loc], outs[3][:, :n_loc])
    return head
