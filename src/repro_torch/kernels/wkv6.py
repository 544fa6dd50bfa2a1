"""WKV6, the RWKV6 linear-attention recurrence: the CUDA kernel's wrapper and
its two plain PyTorch versions.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

``wkv6(r, k, v, w, u, s0)`` with r, k, v, w [B, S, H, hd] (w the decay in
(0, 1)), u [H, hd] and s0 [B, H, hd, hd] (zeros when None) returns
(y [B, S, H, hd], s_end [B, H, hd, hd]), both float32.  It is the port of
``repro/kernels/wkv6.py`` (the Pallas kernel): chunks of 16 tokens, the
per-step log-decay clamped at -9, the chunk-local exponents referenced to
the decay prefix at the middle of the chunk.  Its oracles are
``repro/kernels/ref.py``: ``wkv6_chunked_ref`` (the same chunked math,
ported as ``wkv6_plain``) and ``wkv6_ref`` (the exact sequential
recurrence without the clamp, ported as ``wkv6_sequential_plain``).

A CUDA tensor always launches the hand-written kernel (``csrc/wkv6.cu``)
and raises on what it does not take: float32 only, contiguous, hd in
``HEAD_DIMS``, S a positive multiple of 16.  A CPU tensor uses
``wkv6_plain``.  There is no fallback from one to the other.  ``LAUNCHES``
counts kernel launches, so that a run can show that its main path went
through the kernel.

The gradient (the JAX package differentiates ``wkv6_chunked_ref`` with
``jax.grad``; no Pallas kernel has one): ``wkv6_bwd_plain`` walks the
chunks in reverse, carrying dS, and ``wkv6_bwd`` launches
``csrc/wkv6_bwd.cu`` on a CUDA tensor (``LAUNCHES_BWD``).  The kernel
splits each (b, h)'s chunks into ``bwd_segments`` segments: the dS
entering a segment's end comes from the later segments' folds
(``segment_folds_plain``, ``segment_carry_plain``), and
``wkv6_bwd_plain(..., segments=n)`` walks the segments that way.
``WKV6`` is the autograd Function of the card: its forward launches the
forward kernel's instance that also writes the state entering every
chunk, [B, H, S/16, hd, hd] float32, which the backward reads.  ``wkv6``
goes through it when an input on the card requires grad; on the CPU
autograd differentiates ``wkv6_plain``.  The clamp's derivative is
``jax.grad``'s of ``jnp.maximum``: 1 above -9, 0.5 at log w = -9
exactly, 0 below.
"""
from __future__ import annotations

import ctypes

import torch

CHUNK = 16
LOG_W_MIN = -9.0      # the clamp of the per-step log-decay (wkv6.py:75-78)
HEAD_DIMS = (16, 32, 64)      # the kernel's instantiations
BWD_BLOCKS_PER_SM = 2         # wkv6_bwd's walk: 104 KB, 128 registers
BWD_MAX_SEGMENTS = 64

LAUNCHES = 0
LAUNCHES_BWD = 0


def log_decay(w: torch.Tensor) -> torch.Tensor:
    """The clamped per-step log-decay, float32: log w >= -9 (w >= 1.2e-4).
    A contribution below that dies within a step at float32 precision, and
    the clamp bounds the chunk-local exponents to 8 * 9 = 72.  Written with
    ``torch.maximum``, whose gradient splits a tie as ``jnp.maximum``'s
    does (``torch.clamp``'s gives the whole gradient to the input)."""
    wf = w.float()
    x = torch.log(torch.maximum(wf, wf.new_tensor(1e-38)))
    return torch.maximum(x, x.new_tensor(LOG_W_MIN))


def log_decay_grad(w: torch.Tensor) -> torch.Tensor:
    """d log_decay / dw as ``jax.grad`` of the reference's clamp gives it:
    1 / w above the clamp, 0.5 / w at log w = -9 exactly, 0 below."""
    wf = w.float()
    wf = torch.maximum(wf, wf.new_tensor(1e-38))
    x = torch.log(wf)
    side = torch.where(x > LOG_W_MIN, 1.0, torch.where(
        x == LOG_W_MIN, 0.5, 0.0))
    return side / wf


def _chunked(chunk, *arrays):
    """Each [B, S, H, hd] array as float32 [S / chunk, B, H, chunk, hd]."""
    B, S, H, hd = arrays[0].shape
    n = S // chunk
    return [a.float().reshape(B, n, chunk, H, hd).permute(1, 0, 3, 2, 4)
            for a in arrays]


def wkv6_plain(r, k, v, w, u, s0=None, *, chunk=CHUNK):
    """The chunked recurrence in plain PyTorch, float32 inside and out
    (``ref.wkv6_chunked_ref``): within a chunk a masked strictly-lower
    [C, C] score matrix in log space against the mid-chunk reference, the
    ``u`` diagonal and the carried state; across chunks only the state."""
    B, S, H, hd = r.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    n, C = S // chunk, chunk
    rc, kc, vc, wc = _chunked(chunk, r, k, v, w)         # [n, B, H, C, hd]
    lw = log_decay(wc)
    s = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u_ = u.float()[None, :, None, :]
    lower = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for i in range(n):
        r_, k_, v_, lw_ = rc[i], kc[i], vc[i], lw[i]
        cum = torch.cumsum(lw_, dim=2)              # inclusive decay prefix
        cum_excl = cum - lw_
        ref = cum[:, :, C // 2:C // 2 + 1, :]       # mid-chunk reference
        a_sc = r_ * torch.exp(cum_excl - ref)
        b_sc = k_ * torch.exp(ref - cum)
        sc = torch.einsum("bhtd,bhsd->bhts", a_sc, b_sc)
        sc = torch.where(lower, sc, torch.zeros((), device=r.device))
        diag = torch.einsum("bhtd,bhtd->bht", r_ * u_, k_)
        y = torch.einsum("bhts,bhsd->bhtd", sc, v_) + diag[..., None] * v_
        y = y + torch.einsum("bhtd,bhdv->bhtv", r_ * torch.exp(cum_excl), s)
        last = cum[:, :, -1:, :]
        kd = k_ * torch.exp(last - cum)
        s = torch.exp(last)[:, :, 0, :, None] * s + torch.einsum(
            "bhsd,bhsv->bhdv", kd, v_)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)
    return y, s


def wkv6_sequential_plain(r, k, v, w, u, s0=None):
    """The exact recurrence one token at a time, float32, no clamp
    (``ref.wkv6_ref``)."""
    B, S, H, hd = r.shape
    s = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    u_ = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, s + u_ * kv))
        s = w_t[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def chunk_states_plain(r, k, v, w, s0=None, *, chunk=CHUNK):
    """The state entering every chunk, [B, H, S / chunk, hd, hd] float32
    (the first is s0, or zeros), by ``wkv6_plain``'s state update: what the
    forward kernel's training instance writes for the backward."""
    B, S, H, hd = r.shape
    n = S // chunk
    kc, vc, wc = _chunked(chunk, k, v, w)
    lw = log_decay(wc)
    s = (torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    out = []
    for i in range(n):
        out.append(s)
        cum = torch.cumsum(lw[i], dim=2)
        last = cum[:, :, -1:, :]
        kd = kc[i] * torch.exp(last - cum)
        s = torch.exp(last)[:, :, 0, :, None] * s + torch.einsum(
            "bhsd,bhsv->bhdv", kd, vc[i])
    return torch.stack(out, dim=2)


def bwd_segments(B, S, H, sms, per_sm=BWD_BLOCKS_PER_SM,
                 most=BWD_MAX_SEGMENTS):
    """The segments wkv6_bwd splits each (b, h)'s S / 16 chunks into: the
    count s in 1 .. min(chunks, ``most``) that minimises the makespan in
    chunk-steps, ceil(B H s / (sms per_sm)) waves of ceil(chunks / s)
    chunks and one more for a segment's start (the smallest s of a
    tie)."""
    n = S // CHUNK
    slots = sms * per_sm
    best = None
    for s in range(1, min(n, most) + 1):
        span = -(-B * H * s // slots) * (-(-n // s) + 1)
        if best is None or span < best[0]:
            best = (span, s)
    return best[1]


def segment_bounds(n, segments):
    """[(c0, c1)] of each segment of ``n`` chunks, as the kernel splits
    them: segment q holds chunks q n // segments .. (q + 1) n // segments
    - 1."""
    return [(q * n // segments, (q + 1) * n // segments)
            for q in range(segments)]


def segment_folds_plain(r, w, dy, segments, *, chunk=CHUNK):
    """(D [B, H, segments, hd], L [B, H, segments, hd, hd]) float32: each
    segment's chunks folded in reverse from zero, L <- diag(e^last) L +
    rq^T dy, and D the product of their decays e^last by row (the first
    segment's pair too, which no carry reads)."""
    B, S, H, hd = r.shape
    rc, wc, dyc = _chunked(chunk, r, w, dy)
    lw = log_decay(wc)
    D, L = [], []
    for c0, c1 in segment_bounds(S // chunk, segments):
        dprod = torch.ones(B, H, hd, dtype=torch.float32, device=r.device)
        fold = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
        for i in reversed(range(c0, c1)):
            cum = torch.cumsum(lw[i], dim=2)
            rq = rc[i] * torch.exp(cum - lw[i])
            decay = torch.exp(cum[:, :, -1, :])
            fold = decay[..., None] * fold + torch.einsum(
                "bhtd,bhtv->bhdv", rq, dyc[i])
            dprod = dprod * decay
        D.append(dprod)
        L.append(fold)
    return torch.stack(D, dim=2), torch.stack(L, dim=2)


def segment_carry_plain(D, L, ds_end=None):
    """[B, H, segments, hd, hd] float32: X_s, the gradient of the state
    leaving segment s's last chunk, from ds_end (None: zeros) and the
    later segments' folds in a fixed order, X_s = D_{s+1} X_{s+1} +
    L_{s+1}.  A product of decays that underflowed to 0 multiplies X by 0
    as the sequential walk does chunk by chunk."""
    n = D.shape[2]
    x = (torch.zeros_like(L[:, :, 0]) if ds_end is None
         else ds_end.float())
    out = [x]
    for s in range(n - 2, -1, -1):
        x = D[:, :, s + 1, :, None] * x + L[:, :, s + 1]
        out.append(x)
    return torch.stack(out[::-1], dim=2)


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds_end=None, *, chunk=CHUNK,
                   states=None, segments=1):
    """(dr, dk, dv, dw [B, S, H, hd], du [H, hd], ds0 [B, H, hd, hd]),
    float32: the gradient of ``wkv6_plain``'s (y, s_end) against dy and
    ds_end (None: zeros), chunk by chunk in reverse with the carried dS.
    Each chunk's entering state comes from ``states`` (as the forward
    kernel writes them) or ``chunk_states_plain``.  Per chunk, with a, b,
    rq, kd the decayed operands of the forward and sc its masked scores:

        dv = sc^T dy + diag dy + kd dS          dsc = mask(dy v^T)
        da = dsc b, db = dsc^T a                drq = dy S^T, dkd = v dS^T
        dS <- diag(exp(cum_last)) dS + rq^T dy
        dr = da e^(ce-ref) + drq e^ce + (dy.v) u k, dk likewise
        dlog w: the exponents' gradients, (da a, drq rq) on cum_excl,
        -(db b), -(dkd kd) on cum, the sums on ref and cum_last, through
        the reverse cumsum; dw = dlog w * ``log_decay_grad``.
    du sums (dy.v) r k over the batch and the chunks, in reverse order.
    With ``segments`` > 1 the chunks are split as the kernel splits them
    (``segment_bounds``), and each segment's walk starts from the dS that
    ``segment_carry_plain`` gives it."""
    B, S, H, hd = r.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    n, C = S // chunk, chunk
    if states is None:
        states = chunk_states_plain(r, k, v, w, s0, chunk=chunk)
    rc, kc, vc, wc, dyc = _chunked(chunk, r, k, v, w, dy)   # [n, B, H, C, hd]
    lw, dlw_dw = log_decay(wc), log_decay_grad(wc)
    u_ = u.float()[None, :, None, :]
    lower = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    zero = torch.zeros((), device=r.device)
    if segments == 1:
        carry = [(torch.zeros(B, H, hd, hd, dtype=torch.float32,
                              device=r.device)
                  if ds_end is None else ds_end.float())]
    else:
        carry = segment_carry_plain(
            *segment_folds_plain(r, w, dy, segments, chunk=chunk),
            ds_end).unbind(2)
    starts = {c1 - 1: q for q, (_, c1) in
              enumerate(segment_bounds(n, segments))}
    du = torch.zeros(H, hd, dtype=torch.float32, device=r.device)
    grads = [[None] * n for _ in range(4)]             # dr, dk, dv, dw
    for i in reversed(range(n)):
        if i in starts:
            ds = carry[starts[i]]
        r_, k_, v_, lw_, dy_ = rc[i], kc[i], vc[i], lw[i], dyc[i]
        s_in = states[:, :, i].float()
        cum = torch.cumsum(lw_, dim=2)
        ce = cum - lw_
        ref = cum[:, :, C // 2:C // 2 + 1, :]
        last = cum[:, :, -1:, :]
        ea, eb = torch.exp(ce - ref), torch.exp(ref - cum)
        eq, ek = torch.exp(ce), torch.exp(last - cum)
        decay = torch.exp(last)[:, :, 0, :]                     # [B, H, hd]
        a, b, rq, kd = r_ * ea, k_ * eb, r_ * eq, k_ * ek
        sc = torch.where(lower, torch.einsum("bhtd,bhsd->bhts", a, b), zero)
        diag = torch.einsum("bhtd,bhtd->bht", r_ * u_, k_)
        dsc = torch.where(lower, torch.einsum("bhtv,bhsv->bhts", dy_, v_),
                          zero)
        ddiag = (dy_ * v_).sum(-1)                              # [B, H, C]
        dv_ = (torch.einsum("bhts,bhtv->bhsv", sc, dy_)
               + diag[..., None] * dy_
               + torch.einsum("bhsd,bhdv->bhsv", kd, ds))
        da = torch.einsum("bhts,bhsd->bhtd", dsc, b)
        db = torch.einsum("bhts,bhtd->bhsd", dsc, a)
        drq = torch.einsum("bhtv,bhdv->bhtd", dy_, s_in)
        dkd = torch.einsum("bhsv,bhdv->bhsd", v_, ds)
        ddecay = (ds * s_in).sum(-1)                            # [B, H, hd]
        dr_ = da * ea + drq * eq + ddiag[..., None] * u_ * k_
        dk_ = db * eb + dkd * ek + ddiag[..., None] * u_ * r_
        du = du + torch.einsum("bht,bhtd->hd", ddiag, r_ * k_)
        g_ce = da * a + drq * rq
        g_cum = -(db * b) - dkd * kd
        g_cum[:, :, C // 2] += (db * b).sum(2) - (da * a).sum(2)   # ref
        g_cum[:, :, -1] += (dkd * kd).sum(2) + ddecay * decay      # last
        g_cum = g_cum + g_ce
        g_lw = torch.flip(torch.cumsum(torch.flip(g_cum, [2]), 2), [2]) \
            - g_ce
        for j, g in enumerate((dr_, dk_, dv_, g_lw * dlw_dw[i])):
            grads[j][i] = g
        ds = decay[..., None] * ds + torch.einsum("bhtd,bhtv->bhdv", rq, dy_)
    dr, dk, dv, dw = (torch.stack(g).permute(1, 0, 3, 2, 4).reshape(
        B, S, H, hd) for g in grads)
    return dr, dk, dv, dw, du, ds


def _check(r, k, v, w, u, s0, chunk):
    if chunk != CHUNK:
        raise ValueError(f"the kernel takes chunk={CHUNK}, got {chunk}")
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        named.append(("s0", s0))
    for name, t in named:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if r.dim() != 4:
        raise ValueError(f"r must be [B, S, H, hd], got {tuple(r.shape)}")
    B, S, H, hd = r.shape
    for name, t in named[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, r is "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be [{H}, {hd}], got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"s0 must be [{B}, {H}, {hd}, {hd}], got "
                         f"{tuple(s0.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if S <= 0 or S % CHUNK:
        raise ValueError(f"S={S} is not a positive multiple of {CHUNK}")
    if not 0 < B <= 65535 or not 0 < H <= 65535:
        raise ValueError(f"grid out of range: B {B}, H {H}")
    return B, S, H, hd


def _lib(name="wkv6_launch", lib="wkv6", n_ptr=9, n_int=5):
    from repro_torch.kernels.build import load
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
    return fn


def _forward(r, k, v, w, u, s0, states: bool):
    """(y, s_end, the chunk states or None): one launch of the forward
    kernel, its training instance when ``states``."""
    global LAUNCHES
    B, S, H, hd = _check(r, k, v, w, u, s0, CHUNK)
    y = torch.empty_like(r)
    s_end = torch.empty(B, H, hd, hd, dtype=torch.float32, device=r.device)
    st = (torch.empty(B, H, S // CHUNK, hd, hd, dtype=torch.float32,
                      device=r.device) if states else None)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if s0 is None else s0.data_ptr(),
                y.data_ptr(), s_end.data_ptr(),
                None if st is None else st.data_ptr(), B, S, H, hd,
                r.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel failed to launch: CUDA error {rc}")
    LAUNCHES += 1
    return y, s_end, st


def wkv6_with_states(r, k, v, w, u, s0=None):
    """(y, s_end, the state entering every chunk [B, H, S / 16, hd, hd]),
    float32: the forward kernel's training instance on a CUDA tensor,
    ``wkv6_plain`` and ``chunk_states_plain`` on a CPU tensor."""
    if r.device.type == "cpu":
        return (*wkv6_plain(r, k, v, w, u, s0),
                chunk_states_plain(r, k, v, w, s0))
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 for device {r.device}")
    return _forward(r, k, v, w, u, s0, True)


def _check_bwd(r, k, v, w, u, states, dy, ds_end):
    B, S, H, hd = _check(r, k, v, w, u, None, CHUNK)
    named = [("states", states, (B, H, S // CHUNK, hd, hd)),
             ("dy", dy, (B, S, H, hd))]
    if ds_end is not None:
        named.append(("ds_end", ds_end, (B, H, hd, hd)))
    for name, t, shape in named:
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(t.shape)}")
    return B, S, H, hd


_RESIDENT = {}


def bwd_resident(hd):
    """Blocks of wkv6_bwd's fold, carry scan and walk resident on one SM of
    the current card at head dim hd, as the CUDA runtime computes them
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    if hd not in _RESIDENT:
        from repro_torch.kernels.build import load
        fn = load("wkv6_bwd").wkv6_bwd_resident
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        got = tuple(fn(hd, which) for which in range(3))
        if min(got) <= 0:
            raise RuntimeError(f"wkv6_bwd occupancy at hd {hd}: {got}")
        _RESIDENT[hd] = got
    return _RESIDENT[hd]


def wkv6_bwd(r, k, v, w, u, s0, dy, ds_end=None, *, states):
    """(dr, dk, dv, dw, du, ds0), float32, given the chunk states of
    ``wkv6_with_states`` on the same inputs (they carry s0).  On a CUDA
    tensor one call of ``csrc/wkv6_bwd.cu``: each (b, h)'s chunks split
    into ``bwd_segments`` segments, the segments' folds, their carry scan,
    the walk (one block per (b, h, segment)) and du's sum over (b,
    segment) in fixed order; on a CPU tensor ``wkv6_bwd_plain``."""
    global LAUNCHES_BWD
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds_end, states=states)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6_bwd for device {r.device}")
    _check_bwd(r, k, v, w, u, states, dy, ds_end)
    grads = _bwd_launch(r, k, v, w, u, states, dy, ds_end)
    LAUNCHES_BWD += 1
    return grads


def bwd_plan(B, S, H, hd, device):
    """{"segments", "blocks": {launch: grid size}, "resident": {launch:
    blocks an SM}} of wkv6_bwd on ``device`` at [B, S, H, hd]."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    res = bwd_resident(hd)
    nseg = bwd_segments(B, S, H, sms, per_sm=res[2])
    return {"segments": nseg, "sms": sms,
            "blocks": {"fold": (nseg - 1) * H * B,
                       "carry": -(-hd * hd // 1024) * H * B,
                       "walk": nseg * H * B, "du_sum": -(-H * hd // 256)},
            "resident": {"fold": res[0], "carry": res[1], "walk": res[2]}}


def _bwd_launch(r, k, v, w, u, states, dy, ds_end, parts=15):
    """(dr, dk, dv, dw, du, ds0): one call of ``csrc/wkv6_bwd.cu``'s entry
    on checked CUDA tensors, with the launches whose bits are in ``parts``
    (1 the fold, 2 the carry scan, 4 the walk, 8 du's sum; one alone times
    that launch, on fresh scratch)."""
    B, S, H, hd = r.shape
    nseg = bwd_plan(B, S, H, hd, r.device)["segments"]
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty(H, hd, **f32)
    ds0 = torch.empty(B, H, hd, hd, **f32)
    fold_l = torch.empty(B, H, nseg, hd, hd, **f32)
    fold_d = torch.empty(B, H, nseg, hd, **f32)
    carry = torch.empty(B, H, nseg, hd, hd, **f32)
    du_part = torch.empty(B, nseg, H, hd, **f32)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = _lib("wkv6_bwd_launch", "wkv6_bwd", 18, 7)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        states.data_ptr(), dy.data_ptr(),
        None if ds_end is None else ds_end.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        ds0.data_ptr(), fold_l.data_ptr(), fold_d.data_ptr(),
        carry.data_ptr(), du_part.data_ptr(), B, S, H, hd, nseg, parts,
        r.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd kernel failed to launch: CUDA error "
                           f"{rc}")
    return dr, dk, dv, dw, du, ds0


class WKV6(torch.autograd.Function):
    """WKV6 on the card with a gradient: the forward kernel's training
    instance (it also writes the chunk states), then ``wkv6_bwd``.  CUDA
    tensors only; a None gradient of s_end stands for zeros."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, s_end, states = _forward(r, k, v, w, u, s0, True)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.set_materialize_grads(False)
        return y, s_end

    @staticmethod
    def backward(ctx, dy, ds_end):
        r, k, v, w, u, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        grads = wkv6_bwd(
            r, k, v, w, u, None, dy.contiguous(),
            None if ds_end is None else ds_end.contiguous(), states=states)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6(r, k, v, w, u, s0=None, *, chunk=CHUNK):
    """(y [B, S, H, hd], s_end [B, H, hd, hd]), float32.  On a CUDA tensor
    this launches the kernel on the current stream, through ``WKV6`` when
    an input requires grad; on a CPU tensor it is ``wkv6_plain``, which
    autograd differentiates."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no wkv6 for device {r.device}")
    _check(r, k, v, w, u, s0, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        return WKV6.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0, False)[:2]
