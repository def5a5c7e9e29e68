"""Plain PyTorch versions of the half-sweep arithmetic.

`field_decision_update` is THE half-sweep body: eqn 2 (tanh activation,
additive RNG, comparator sign, masked write) in one place.  The scan
backends ("ref", "sparse") loop over it; the CUDA kernels in
`sweep_fused` and `pbit_update` reproduce the same sequence term for term.
Counterpart of ``repro.kernels.ref``.

Eqn 1 has one summation order everywhere: a sequential float32 sum from
+0.0 in ascending source-node order, then ``+ h``.  Spins are ±1, so every
product is exact, and adding a ±0.0 term to an accumulator that started at
+0.0 leaves it unchanged; so the dense row reduction over all j, the same
reduction over a row's nonzero entries only, and the ascending slot sum of
the Chimera layout are one and the same number, bit for bit.
"""
from __future__ import annotations

import torch


def decision_value(I, gain, off, rand_gain, comp_off, beta, u):
    """Pre-comparator decision of eqn 2.  Op order is load-bearing:
    ``act = tanh((beta*gain)*(I+off))``, then ``(act + rand_gain*u) +
    comp_off``, every step rounded to float32 on its own."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=I.device)
    if beta.ndim == 1:
        beta = beta[:, None]
    act = torch.tanh(beta * gain * (I + off))
    return act + rand_gain * u + comp_off


def field_decision_update(m, I, gain, off, rand_gain, comp_off,
                          update_mask, beta, u):
    """Eqn 2 on a precomputed neuron input I: the shared half-sweep tail.

    m/I/u: (B, N);  gain/off/rand_gain/comp_off: (N,);  update_mask: (N,)
    bool;  beta: scalar or (B,) per-chain inverse temperature.
    """
    decision = decision_value(I, gain, off, rand_gain, comp_off, beta, u)
    new = torch.where(decision >= 0.0, 1.0, -1.0).to(m.dtype)
    return torch.where(update_mask, new, m)


def scatter_edge_slots(codes, edges, slot_ij, slot_ji, degree, n_nodes):
    """Scatter (E,) edge-list values into the (D, N) slot layout, both
    directions: out[slot_ij[e], edges[e, 0]] = out[slot_ji[e], edges[e, 1]]
    = codes[e].  edges/slot tables: int64 tensors on codes' device."""
    out = torch.zeros((degree, n_nodes), dtype=codes.dtype,
                      device=codes.device)
    out[slot_ij, edges[:, 0]] = codes
    out[slot_ji, edges[:, 1]] = codes
    return out


def sparse_neuron_input(m, nbr_idx, nbr_w, h):
    """Eqn 1 on the fixed-degree slot layout: I = Σ_d w_d ⊙ m[:, idx_d] + h.

    m: (B, N);  nbr_idx/nbr_w: (D, N).  Slots accumulate in ascending-d
    order from zero and ``+ h`` comes last — the order the CUDA kernel
    uses, so the two agree bit for bit (``w * m`` with m = ±1 is exact).
    """
    acc = torch.zeros((m.shape[0], nbr_idx.shape[1]), dtype=torch.float32,
                      device=m.device)
    for d in range(nbr_idx.shape[0]):
        acc = acc + nbr_w[d][None, :] * m.index_select(1, nbr_idx[d])
    return acc + h


def row_tables(W):
    """Each row's nonzero entries of the dense (N, N) W as a fixed-degree
    table ``(idx, w)``, both (K, N) with K the largest row count: column
    ``i`` lists row i's nonzero j ascending, padded with zero-weight
    entries.  `sparse_neuron_input` on these tables is the dense row
    reduction of `dense_neuron_input`, bit for bit."""
    nonzero = W != 0
    K = max(int(nonzero.sum(dim=1).max()), 1) if W.shape[0] else 1
    # stable: the nonzero columns first, each group in ascending j
    order = torch.argsort((~nonzero).to(torch.uint8), dim=1, stable=True)
    idx = order[:, :K]
    return idx.T.contiguous(), W.gather(1, idx).T.contiguous()


def dense_neuron_input(m, W, h):
    """Eqn 1 on the dense layout: I[b, i] = Σ_j W[i, j] m[b, j] + h[i], as
    the sequential row reduction in ascending j from +0.0 (not ``m @ W.T``,
    whose order is the library's).  Only each row's nonzero entries are
    visited, which is the same sum (see the module docstring)."""
    idx, w = row_tables(W)
    return sparse_neuron_input(m, idx, w, h)


def pbit_half_sweep_ref(m, W, h, gain, off, rand_gain, comp_off,
                        update_mask, beta, u):
    """Dense chromatic-Gibbs half-sweep, reference semantics.

    m: (B, N) spins in {-1, +1};  W: (N, N) directional couplings
    (I_i = Σ_j W[i, j] m_j);  h/gain/off/rand_gain/comp_off: (N,);
    update_mask: (N,) bool;  beta: scalar or (B,) per-chain inverse
    temperature;  u: (B, N) uniform noise.  Every input is read before any
    spin is written (synchronous), whatever couplings W holds.
    """
    I = dense_neuron_input(m, W, h)
    return field_decision_update(m, I, gain, off, rand_gain, comp_off,
                                 update_mask, beta, u)


def pbit_sparse_half_sweep_ref(m, nbr_idx, nbr_w, h, gain, off, rand_gain,
                               comp_off, update_mask, beta, u):
    """One colour half-sweep on the slot layout."""
    I = sparse_neuron_input(m, nbr_idx, nbr_w, h)
    return field_decision_update(m, I, gain, off, rand_gain, comp_off,
                                 update_mask, beta, u)


def halo_exchange_segments(ex_pts, n_half):
    """Exchange points -> half-sweep windows [(h0, h1), ...] of a launch.

    The segmentation rule of the fused-resident-exchange loop shape: a
    launch of ``n_half`` half-sweeps splits at its `Sync.exchange_points()`
    into contiguous windows, each preceded by one halo refresh.  K5
    (`sweep_fused.py::sweep_sparse_exchange`), its plain version and the
    engine's emulation (`ShardedEngine` windows of K1) all consume this, so
    their exchange placement is identical by construction.
    """
    pts = tuple(ex_pts)
    if not pts or pts[0] != 0:
        raise ValueError(f"exchange points must start at 0, got {pts}")
    if any(not 0 <= p < n_half for p in pts):
        raise ValueError(
            f"exchange points {pts} outside the launch's {n_half} "
            f"half-sweeps")
    return tuple(zip(pts, pts[1:] + (n_half,)))


def lattice_vertical_update_ref(m_v, m_h, m_v_up, m_v_dn, W_vh, wv_up,
                                wv_dnin, h, gain, u, parity, color):
    """SoA Chimera-lattice vertical half-step, plain PyTorch.

    Planes m_v/m_h/m_v_up/m_v_dn/u: (B, R, C, k);  W_vh: (R, C, k, k);
    wv_up/wv_dnin/h/gain: (R, C, k);  parity: (R, C) int;  color: 0 or 1.
    ``I = h + wv_dnin·m_v_up + wv_up·m_v_dn + Σ_j W_vh[r,c,i,j]·m_h[b,r,c,j]``
    in the reference kernel's order (``lattice_vertical_update_pallas``):
    the vertical terms onto ``h`` first, then the j terms in ascending j
    (not an einsum, whose order is the library's) — and ``m_v' =
    sgn(tanh(gain·I) + u)`` where the cell's parity equals ``color``, else
    ``m_v``.  The CUDA kernel (`kernels/lattice_update.py`) repeats this
    term for term.
    """
    acc = h + wv_dnin * m_v_up + wv_up * m_v_dn
    for j in range(W_vh.shape[-1]):
        acc = acc + W_vh[..., j] * m_h[..., j:j + 1]
    act = torch.tanh(gain * acc)
    new = torch.where(act + u >= 0.0, 1.0, -1.0).to(m_v.dtype)
    upd = (parity == color)[None, :, :, None]
    return torch.where(upd, new, m_v)
