"""Plain PyTorch versions of the kernels on the main path.

Port of ``repro.kernels.ref``'s ``local_field_init``,
``bitplane_field_init``, ``mcmc_sweep`` and ``colored_sweep`` (dense J or
packed planes), the keyed sweeps' per-thread draws (``sweep_uniforms``,
``colored_uniforms``), ``flash_attention`` (the forward of
``repro.kernels.flash_attention``, whose oracle in the JAX package is
``models.layers.chunked_attention``) and ``flash_attention_bwd`` (its
gradients, which the JAX package's ``_flash_bwd`` takes by autodiff through
that oracle). The wrappers in ``local_field.py``,
``bitplane_field.py``, ``sweep.py`` and ``flash_attention.py`` run these for
CPU tensors; the tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import coupling as coupling_store
from ..core import rng
from ..core.bitplane import BitPlanes, hamming_fields
from . import common

NEG_INF = -1e30


def local_field_init(spins: torch.Tensor, couplings: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """u[r, i] = Σ_j J_ij s[r, j] + h_i (paper Eq. 11 batched over replicas),
    the contraction of ``repro.core.ising.local_fields``."""
    s = spins.to(torch.float32)
    return (torch.einsum("ij,...j->...i", couplings.to(torch.float32), s)
            + bias.to(torch.float32))


def bitplane_field_init(pos: torch.Tensor, neg: torch.Tensor,
                        spin_words: torch.Tensor) -> torch.Tensor:
    """Hamming-weight accumulation (paper Eq. 14-16) over packed planes:
    pos/neg (B, N, W) and spin_words (R, W) int32-held words → (R, N) f32
    (``core.bitplane.hamming_fields``)."""
    return hamming_fields(pos, neg, spin_words)


def mcmc_sweep(couplings, fields0: torch.Tensor,
               spins0: torch.Tensor, energy0: torch.Tensor,
               uniforms: torch.Tensor, temps: torch.Tensor,
               pwl_table: Optional[torch.Tensor] = None, *, mode: str = "rsa",
               uniformized: bool = False, lane: Optional[int] = None,
               coupling: Optional[str] = None, block_r: int = 8,
               coalesce: bool = True):
    """T-step dual-mode sweep over R replicas (paper Alg. 1 inner loop).

    couplings: (N, N) dense, or a ``BitPlanes`` whose rows are gathered and
    decoded by ``common.decode_bitplane_rows``. fields0/spins0 (R, N);
    energy0 (R,); uniforms (T, R, 4) f32 (site, accept, roulette,
    uniformize); temps (T, R); ``pwl_table`` optional (S+1, 3) (None = exact
    sigmoid). ``coupling`` names the tier (default: "bitplane" for planes,
    else "dense"). RWA picks with ``common.roulette_pick_tree``, the card's
    tree (JAX's lane-order ``roulette_pick`` agrees except near ties), so
    ``lane`` is accepted for JAX's signature and not read. Returns ``(fields, spins, energy, best_energy, best_spins,
    num_flips, rows_fetched)``: rows_fetched counts one row per replica per
    step, or, on a coalescable tier with ``coalesce``, each step's unique
    sites per group of ``fit_block(R, block_r)`` replicas, charged to the
    lowest replica selecting each (accepted or not).
    """
    if mode not in ("rsa", "rwa"):
        raise ValueError(f"mode must be 'rsa' or 'rwa', got {mode!r}")
    if isinstance(couplings, BitPlanes):
        n = couplings.num_spins
        pos, neg = couplings.pos, couplings.neg
        coupling = "bitplane" if coupling is None else coupling

        def fetch_rows(j):
            return common.decode_bitplane_rows(pos[:, j], neg[:, j], n)
    else:
        n = couplings.shape[0]
        J = couplings.to(torch.float32)
        coupling = "dense" if coupling is None else coupling

        def fetch_rows(j):
            return J[j]
    coalesce = coalesce and coupling_store.FORMATS[coupling].coalescable
    r = fields0.shape[0]
    num_steps = uniforms.shape[0]
    rows_idx = torch.arange(r, device=fields0.device)

    u = fields0.to(torch.float32).clone()
    s = spins0.clone()
    e = energy0.to(torch.float32).clone()
    be = e.clone()
    bs = spins0.clone()
    nf = torch.zeros(r, dtype=torch.int32, device=fields0.device)
    rf = torch.zeros(r, dtype=torch.int32, device=fields0.device)
    for t in range(num_steps):
        u01 = uniforms[t]
        temp = temps[t]
        sf = s.to(torch.float32)
        if mode == "rsa":
            j = common.site_from_uniform(u01[:, 0], n)
            de = 2.0 * sf[rows_idx, j] * u[rows_idx, j]
            accept = u01[:, 1] < common.flip_probability(de, temp, pwl_table)
        else:
            de_all = 2.0 * sf * u
            p_all = common.flip_probability(de_all, temp[:, None], pwl_table)
            j_rw, total, degenerate = common.roulette_pick_tree(
                p_all, u01[:, 2])
            if uniformized:
                accept = ~degenerate & (u01[:, 3] * float(n) < total)
                j = j_rw
            else:
                j_fb = common.site_from_uniform(u01[:, 0], n)
                p_fb = p_all[rows_idx, j_fb]
                accept = torch.where(degenerate, u01[:, 1] < p_fb,
                                     torch.ones_like(degenerate))
                j = torch.where(degenerate, j_fb, j_rw)
            de = de_all[rows_idx, j]
        s_old = sf[rows_idx, j]
        acc_f = accept.to(torch.float32)
        u = u - (2.0 * acc_f * s_old)[:, None] * fetch_rows(j)
        rf = rf + common.rows_fetched_step(j, block_r, coalesce)
        s = s.clone()
        s[rows_idx, j] = torch.where(accept, -s[rows_idx, j], s[rows_idx, j])
        e = e + acc_f * de
        nf = nf + accept.to(torch.int32)
        better = e < be
        be = torch.where(better, e, be)
        bs = torch.where(better[:, None], s, bs)
    return u, s, e, be, bs, nf, rf


def sweep_chunk_key(base_words, chunk: int,
                    fold: Optional[int] = None) -> torch.Tensor:
    """The key of a keyed sweep chunk from the base key's two words:
    ``stream(base, SWEEP, chunk)``, or with a device ``fold``
    ``stream(base, SWEEP, fold, chunk)``."""
    base = rng.from_words(*base_words)
    if fold is None:
        return rng.stream(base, rng.Salt.SWEEP, chunk)
    return rng.stream(base, rng.Salt.SWEEP, fold, chunk)


def sweep_uniforms(base_words, chunk: int, num_steps: int, r: int,
                   fold: Optional[int] = None) -> torch.Tensor:
    """The (T, R, 4) uniforms the card's keyed sweep draws, computed as its
    blocks stage them: the chunk key :func:`sweep_chunk_key` from the base
    key's two words (and a device ``fold``), then, window by window of
    ``common.SWEEP_WINDOW`` steps, thread ``tid`` of replica r's block
    takes slot ``tid % 4`` of step ``t0 + tid // 4``: the bits ``o1 ^ o2``
    of threefry2x32(chunk_key, (0, (t·R + r)·4 + slot)), rounded to f32
    and scaled by 2⁻³². The plain version of ``snowball_sweep_uniforms``;
    equal to ``rng.uniform01(sweep_chunk_key(base_words, chunk, fold),
    (T, R, 4))``."""
    key = sweep_chunk_key(base_words, chunk, fold)
    out = torch.empty((num_steps, r, 4), dtype=torch.float32)
    tid = torch.arange(4 * common.SWEEP_WINDOW, dtype=torch.int64)
    reps = torch.arange(r, dtype=torch.int64)
    for t0 in range(0, num_steps, common.SWEEP_WINDOW):
        t = t0 + tid // 4
        slot = tid % 4
        keep = t < num_steps
        t, slot = t[keep], slot[keep]
        count = (t[:, None] * r + reps[None, :]) * 4 + slot[:, None]
        o1, o2 = rng.threefry2x32(key[0], key[1], torch.zeros_like(count),
                                  count & rng.MASK32)
        out[t[:, None], reps[None, :], slot[:, None]] = (
            (o1 ^ o2).to(torch.float32) * (2.0 ** -32))
    return out


def colored_uniforms(base_words, chunk: int, sched: torch.Tensor, r: int,
                     window: int, n: int) -> torch.Tensor:
    """The (T, R, S) uniforms the card's keyed colored sweep draws, computed
    as its threads draw them: the chunk key ``fold_in(fold_in(base,
    SWEEP), chunk)`` from the base key's two words; at step t, the thread
    deciding replica r's window slot k (spin w + k, w the window start
    clamped into [0, N − S]) where w + k lies in the class [offset,
    offset + size) takes the bits ``o1 ^ o2`` of threefry2x32(chunk_key,
    (0, (t·R + r)·S + k)), rounded to f32 and scaled by 2⁻³². A slot
    outside the class is never drawn (it is never accepted) and reads 1.
    The plain version of the keyed colored kernel's draw; equal to
    ``rng.uniform01(rng.stream(base, SWEEP, chunk), (T, R, S))`` at the
    class slots."""
    key = rng.fold_in(rng.fold_in(rng.from_words(*base_words),
                                  rng.Salt.SWEEP), chunk)
    sched = sched.cpu().to(torch.int64)
    t = sched.shape[0]
    w = sched[:, 0].clamp(0, n - window)
    idx = w[:, None] + torch.arange(window)[None, :]               # (T, S)
    klass = (idx >= sched[:, 1:2]) & (idx < sched[:, 1:2] + sched[:, 2:3])
    out = torch.ones((t, r, window), dtype=torch.float32)
    tt, kk = torch.nonzero(klass, as_tuple=True)
    reps = torch.arange(r, dtype=torch.int64)
    count = (tt[:, None] * r + reps[None, :]) * window + kk[:, None]
    o1, o2 = rng.threefry2x32(key[0], key[1], torch.zeros_like(count),
                              count & rng.MASK32)
    out[tt[:, None], reps[None, :], kk[:, None]] = (
        (o1 ^ o2).to(torch.float32) * (2.0 ** -32))
    return out


def colored_sweep(couplings, fields0: torch.Tensor, spins0: torch.Tensor,
                  energy0: torch.Tensor, uniforms: torch.Tensor,
                  temps: torch.Tensor, sched: torch.Tensor,
                  pwl_table: Optional[torch.Tensor] = None, *,
                  block_r: int = 8):
    """T graph-colored block-Gibbs steps over R replicas (spins in
    color-sorted order), the plain version of ``kernels.sweep.colored_sweep``.

    ``sched`` (T, 3) int32 rows of (window_start, class_offset, class_size);
    ``uniforms`` (T, R, S) accept streams over the static class window S.
    Each step every member of the scheduled class takes an independent
    heat-bath flip off the live local fields, then the accepted slots' row
    updates are applied slot by slot in ascending order. As in the
    reference, a slot's update is gated on "any replica of the
    ``fit_block(R, block_r)`` group accepted it" (a replica of the group that
    did not accept applies ``u − 0·row``), and ``rows_fetched`` counts one
    row per such slot, charged to the group's lowest-index accepting
    replica. Returns ``(fields, spins, energy, best_energy, best_spins,
    num_flips, rows_fetched)``.
    """
    if isinstance(couplings, BitPlanes):
        n = couplings.num_spins
        pos, neg = couplings.pos, couplings.neg

        def fetch_rows(j):
            return common.decode_bitplane_rows(pos[:, j], neg[:, j], n)
    else:
        n = couplings.shape[0]
        J = couplings.to(torch.float32)

        def fetch_rows(j):
            return J[j]
    dev = fields0.device
    r = fields0.shape[0]
    br = common.fit_block(r, block_r)
    g = r // br
    win = uniforms.shape[2]
    ids = torch.arange(br, device=dev)
    slots = torch.arange(win, device=dev)

    u = fields0.to(torch.float32).clone()
    s = spins0.to(torch.float32).clone()
    e = energy0.to(torch.float32).clone()
    be = e.clone()
    bs = s.clone()
    nf = torch.zeros(r, dtype=torch.int32, device=dev)
    rf = torch.zeros(r, dtype=torch.int32, device=dev)
    for t, (w, off, size) in enumerate(sched.tolist()):
        w = min(max(w, 0), n - win)     # dynamic_slice clamps the window
        s_win = s[:, w:w + win]
        de = 2.0 * s_win * u[:, w:w + win]
        p = common.flip_probability(de, temps[t][:, None], pwl_table)
        idx = slots + w
        valid = (idx >= off) & (idx < off + size)
        accept = (uniforms[t] < p) & valid[None, :]
        acc_f = accept.to(torch.float32)
        e = e + torch.sum(acc_f * de, dim=1)
        nf = nf + accept.to(torch.int32).sum(dim=1, dtype=torch.int32)
        coef = 2.0 * acc_f * s_win                  # 2·acc·s_old per slot
        s = s.clone()
        s[:, w:w + win] = s_win * (1.0 - 2.0 * acc_f)
        acc_b = accept.reshape(g, br, win)
        anyacc = acc_b.any(dim=1)                   # (G, S)
        first = torch.where(acc_b, ids[None, :, None],
                            torch.full_like(ids, br)[None, :, None]).amin(1)
        hit = anyacc[:, None, :] & (ids[None, :, None] == first[:, None, :])
        rf = rf + hit.reshape(r, win).sum(dim=1, dtype=torch.int32)
        gate = anyacc.repeat_interleave(br, dim=0)  # (R, S)
        ks = torch.nonzero(anyacc.any(dim=0)).flatten()
        rows = fetch_rows(ks + w) if ks.numel() else None
        for a, k in enumerate(ks.tolist()):
            u = torch.where(gate[:, k:k + 1], u - coef[:, k:k + 1] * rows[a],
                            u)
        better = e < be
        be = torch.where(better, e, be)
        bs = torch.where(better[:, None], s, bs)
    return (u, s.to(spins0.dtype), e, be, bs.to(spins0.dtype), nf, rf)


#: Score elements one step of the plain attention holds (f32): 512 MiB.
FLASH_PLAIN_SCORE_ELEMENTS = 1 << 27


#: log2(e), the factor from natural to log2 units of the saved lse.
LOG2E = 1.4426950408889634

#: Kernel E's forward lse against ``flash_attention``'s (``return_lse``):
#: max |kernel − plain| in the lse's log2 units. ``chip_smoke.py``'s
#: ``flash_backward_check`` reads at most 2.861e-6 on an H100 80GB HBM3 at
#: 700 W over D 16 to 256, causal and not, GQA and ragged shapes (PERF.md
#: §6); p 1 % high moves it by log2 1.01 = 1.4e-2.
FLASH_LSE_TOL = 1e-5
#: Kernel E's backward against ``flash_attention_bwd`` on the same q, k, v,
#: out, lse and dO: max |kernel − plain| / max |plain| of each gradient.
#: The same check reads bf16 at most 4.274e-3, where a planted fault, p 1 %
#: high, reads 1.154e-2 to 1.538e-2 and dropping Δ up to 1.54; f32 at most
#: 5.3e-6, held to the forward's 2e-5.
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float, return_lse: bool = False):
    """Straightforward GQA attention with the flash kernels' cast points:
    the scores, the softmax and P·V in f32, the causal mask ``row >= col``
    on absolute positions (top-left aligned), out = acc / max(l, 1e-30)
    cast to q's dtype (round to nearest even).

    f32 inputs: q·scale in f32, as the TPU kernel and the CUDA-core kernel.
    bf16 inputs, as the tensor-core kernel: q and k enter the product as
    their bf16 values, the scale multiplies the f32 scores, and
    p = exp(s − m) is rounded to bf16 before P·V (the row sum l adds the
    f32 p). The kernel's m is the running max of the keys seen so far, this
    version's the max of the whole row, so the two round p relative to
    different maxima and may differ in the last bf16 digit of out.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D). The scores of one batch entry
    and a slice of query rows are formed at a time, at most
    ``FLASH_PLAIN_SCORE_ELEMENTS`` of them. With ``return_lse`` also the
    rows' log-sum-exp in the kernels' units, log2 with the scale folded in
    (``(m + ln l)·log2 e``, f32, (B, Hq, Sq)); ``out`` is the same either
    way.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    bf16 = q.dtype == torch.bfloat16
    rows = max(1, FLASH_PLAIN_SCORE_ELEMENTS // (hq * skv))
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    cols = torch.arange(skv, device=q.device)
    for bi in range(b):
        kb, vb = k[bi].float(), v[bi].float()                 # (Hkv, Skv, D)
        qb = q[bi].reshape(hkv, rep, sq, d)
        for r0 in range(0, sq, rows):
            r1 = min(sq, r0 + rows)
            qs = qb[:, :, r0:r1].float()                      # (Hkv, rep, n, D)
            if not bf16:
                qs = qs * scale
            s = torch.matmul(qs.reshape(hkv, -1, d), kb.transpose(1, 2))
            s = s.reshape(hkv, rep, r1 - r0, skv)
            if bf16:
                s = s * scale
            if causal:
                pos = torch.arange(r0, r1, device=q.device)
                mask = pos[:, None] >= cols[None, :]
                s = torch.where(mask, s, NEG_INF)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            if causal:
                p = torch.where(mask, p, 0.0)
            l = p.sum(dim=-1, keepdim=True)
            if lse is not None:
                lse[bi, :, r0:r1] = ((m + torch.log(l)) * LOG2E).reshape(
                    hq, r1 - r0)
            if bf16:
                p = p.to(torch.bfloat16).float()
            acc = torch.matmul(p.reshape(hkv, -1, skv), vb)
            o = acc.reshape(hkv, rep, r1 - r0, d) / torch.clamp(l, min=1e-30)
            out[bi, :, r0:r1] = o.reshape(hq, r1 - r0, d).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool, scale: float):
    """The gradients (dq, dk, dv) of :func:`flash_attention` for the output
    gradient ``dout``, from its ``out`` and ``lse``: the backward kernel's
    three passes written straight, with its cast points.

    (a) Δ = rowsum(dout ∘ out) in f32. Then for each slice of query rows
    p = 2^(x − lse), x the scores in log2 units (f32 inputs: ((q·scale)·k)
    ·log2 e; bf16: (q·k)·(scale·log2 e), q and k as their bf16 values, the
    factor rounded to f32 as the kernel folds it), masked as the forward;
    dp = dout·vᵀ and ds = p ∘ (dp − Δ) in f32; (b) dv += pᵀ·dout and
    dk += dsᵀ·q summed over the slices and the GQA group's heads; (c)
    dq = ds·k. bf16 inputs round p and ds to bf16 as the operands of those
    products and multiply dk and dq by the scale in f32 at the end; f32
    inputs take dk = dsᵀ·(q·scale), dq = (ds·k)·scale. The gradients are
    returned in the inputs' dtypes. At most ``FLASH_PLAIN_SCORE_ELEMENTS``
    scores are formed at a time.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    bf16 = q.dtype == torch.bfloat16
    factor = torch.tensor(scale if bf16 else 1.0, dtype=torch.float32,
                          device=q.device) * LOG2E
    rows = max(1, FLASH_PLAIN_SCORE_ELEMENTS // (hq * skv))
    delta = (dout.float() * out.float()).sum(dim=-1)          # (B, Hq, Sq)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    cols = torch.arange(skv, device=q.device)
    for bi in range(b):
        kb, vb = k[bi].float(), v[bi].float()                 # (Hkv, Skv, D)
        qb = q[bi].reshape(hkv, rep, sq, d)
        gb = dout[bi].reshape(hkv, rep, sq, d)
        lb = lse[bi].reshape(hkv, rep, sq, 1)
        db = delta[bi].reshape(hkv, rep, sq, 1)
        dk_acc = torch.zeros((hkv, skv, d), device=q.device)
        dv_acc = torch.zeros((hkv, skv, d), device=q.device)
        for r0 in range(0, sq, rows):
            r1 = min(sq, r0 + rows)
            n = rep * (r1 - r0)
            qs = qb[:, :, r0:r1].float().reshape(hkv, n, d)
            if not bf16:
                qs = qs * scale
            go = gb[:, :, r0:r1].float().reshape(hkv, n, d)
            s = torch.matmul(qs, kb.transpose(1, 2)).reshape(
                hkv, rep, r1 - r0, skv)
            p = torch.exp2(s * factor - lb[:, :, r0:r1])
            if causal:
                pos = torch.arange(r0, r1, device=q.device)
                p = torch.where(pos[:, None] >= cols[None, :], p, 0.0)
            dp = torch.matmul(go, vb.transpose(1, 2)).reshape(
                hkv, rep, r1 - r0, skv)
            ds = (p * (dp - db[:, :, r0:r1])).reshape(hkv, n, skv)
            p = p.reshape(hkv, n, skv)
            if bf16:
                p = p.to(torch.bfloat16).float()
                ds = ds.to(torch.bfloat16).float()
            dv_acc += torch.matmul(p.transpose(1, 2), go)
            dk_acc += torch.matmul(ds.transpose(1, 2), qs)
            dqs = torch.matmul(ds, kb) * scale
            dq[bi, :, r0:r1] = dqs.reshape(hq, r1 - r0, d).to(q.dtype)
        if bf16:
            dk_acc = dk_acc * scale
        dk[bi] = dk_acc.to(k.dtype)
        dv[bi] = dv_acc.to(v.dtype)
    return dq, dk, dv
