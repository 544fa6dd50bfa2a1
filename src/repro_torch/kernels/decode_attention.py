"""Flash decode: the CUDA kernels' wrapper and their plain PyTorch version.

``decode_attention(q, k_cache, v_cache, pos)`` with q [B, H, hd] (one token
per row) and caches [B, L, KV, hd] returns [B, H, hd] in q's type: softmax
attention over the cache in float32, scores ``(q * scale) . k``, an
optional logit softcap, grouped KV heads (kv head = h // (H // KV)), and a
mask that keeps slot j when its position p satisfies p <= pos and, with a
window, p > pos - window.  The position of slot j is j, or ``k_pos[j]``
when a slot -> position map is given: the ring buffer of a sliding-window
cache (``modeling/attention.py:ring_positions``), with 2**30 for an empty
slot.  With ``k_pos=None`` this is the Pallas kernel
``repro/kernels/decode_attention.py`` (oracle ``ref.decode_attention_ref``);
``k_pos`` is the ``buf_offset`` of ``repro/modeling/attention.py``'s
``decode_attention``.

``pos`` is a host int, one for the whole batch, so that no decode step
waits on the device.  A CUDA tensor always launches the hand-written
kernel (``csrc/decode_attention.cu``: one launch; tiles of cache slots
scored on tensor cores in bf16, the parts of the cache merged inside the
launch) and raises on what it does not take; a CPU tensor uses
``decode_attention_plain``.  There is no fallback from one to the other.
``LAUNCHES`` counts kernel launches.

``mla_decode_attention(q_lat, q_rope, ckv, krope, pos, scale)`` is the
decode step of multi-head latent attention in absorbed form (MLA,
minicpm3-4b; ``repro/modeling/attention.py:_mla_apply``, lines 457-475),
which no Pallas kernel computes: scores ``(q_lat . ckv + q_rope . krope)
* scale`` in float32 over the two latent caches, slots ``<= pos``, softmax,
times ckv itself.  A CUDA tensor launches ``csrc/mla_decode.cu`` (bf16:
wgmma and TMA, the parts of a batch row's cache in one thread-block
cluster that merges them inside the launch; float32: SIMT, the parts
merged by a second small launch), a CPU tensor takes
``mla_decode_attention_plain``.  ``mla_plan`` cuts the cache into parts;
``MLA_LAUNCHES`` counts its calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -2.0e38
HEAD_DIMS = (64, 128, 256)       # the kernel's instantiations
GROUPS = (1, 2, 4, 8)            # query heads per kv head it takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PARTS = 1024                 # parts of one (batch, kv head)

LAUNCHES = 0
_COUNTERS = {}                   # device -> int32 ticket counters, kept zero
# MLA decode: (heads, latent width, rope width) of its one instance,
# minicpm3-4b's
MLA_SHAPE = (40, 256, 32)
MLA_LAUNCHES = 0


def _mask(k_pos, L, pos, window, device):
    kp = torch.arange(L, device=device) if k_pos is None else k_pos
    ok = kp <= pos
    if window:
        ok &= kp > pos - window
    return ok


def decode_attention_plain(q, k_cache, v_cache, pos, *, window=0,
                           softcap=0.0, scale=None, k_pos=None):
    """The same function in plain PyTorch, float32 inside, out in q's
    type."""
    B, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    qg = q.float().reshape(B, KV, G, hd) * scale
    s = torch.einsum("bkgh,blkh->bkgl", qg, k_cache.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = _mask(k_pos, L, pos, window, q.device)
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkh->bkgh", p, v_cache.float())
    return o.reshape(B, H, v_cache.shape[-1]).to(q.dtype)


def slot_range(L, pos, window, k_pos):
    """[lo, hi): the cache slots the kernel walks.  Without a slot map
    only positions pos - window + 1 .. pos can be kept; with one, or when
    no slot can be kept (then every score is NEG_INF and the answer is the
    plain version's uniform average), the whole cache."""
    if k_pos is not None:
        return 0, L
    lo = max(0, pos - window + 1) if window else 0
    hi = min(L, pos + 1)
    return (lo, hi) if lo < hi else (0, L)


@functools.lru_cache(maxsize=None)
def tile_config(hd, dtype, G, device_index) -> dict:
    """The kernel's tiling at head dim ``hd``, ``dtype`` and G query rows
    a kv head on CUDA device ``device_index``, as its library reports it
    (``decode_attention_config``): kT slots a tile, W warps a block, SMEM
    bytes of dynamic shared memory a block and ``blocks_per_sm`` resident
    blocks an SM; beside them ``sms``, the card's multiprocessors."""
    cfg = (ctypes.c_int * 4)()
    rc = _lib().decode_attention_config(DTYPES[dtype], hd, G, device_index,
                                        cfg)
    if rc != 0 or cfg[3] < 1:
        raise RuntimeError(f"decode_attention has no resident block at hd "
                           f"{hd}, {dtype}, G {G}: CUDA error {rc}")
    props = torch.cuda.get_device_properties(device_index)
    return {"kT": cfg[0], "W": cfg[1], "SMEM": cfg[2],
            "blocks_per_sm": cfg[3], "sms": props.multi_processor_count}


@functools.lru_cache(maxsize=4096)
def decode_plan(n_slots, B, KV, W, blocks_per_sm, sms):
    """(slots per warp, parts) for n_slots slots of B * KV heads and blocks
    of W warps: as many parts as give one wave of resident blocks
    (``blocks_per_sm`` on each of ``sms`` multiprocessors), at least 16
    slots a warp, and every warp's run a multiple of 16 slots (one
    tensor-core tile of slots)."""
    n_parts = max(1, min(MAX_PARTS, sms * blocks_per_sm // (B * KV),
                         -(-n_slots // (16 * W))))
    per_warp = 16 * -(-n_slots // (16 * W * n_parts))
    return per_warp, -(-n_slots // (W * per_warp))


def _check(q, k_cache, v_cache, pos, window, k_pos):
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B, H, hd] and the caches [B, L, KV, "
                         f"hd], got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, hd = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (B, L, KV, hd) or \
            tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if KV < 1 or H % KV or H // KV not in GROUPS:
        raise ValueError(f"{H} query heads over {KV} kv heads: the kernel "
                         f"takes {GROUPS} query heads per kv head")
    if L < 1 or B * KV > 65535 or B * L * KV * hd >= 2 ** 62:
        raise ValueError(f"cache shape {tuple(k_cache.shape)} not taken")
    if isinstance(pos, torch.Tensor) or not 0 <= int(pos) < 2 ** 31:
        raise ValueError(f"pos must be a host int in [0, 2**31), got {pos!r}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if k_pos is not None:
        if k_pos.device != q.device or k_pos.dtype != torch.int32 or \
                tuple(k_pos.shape) != (L,) or not k_pos.is_contiguous():
            raise ValueError("k_pos must be a contiguous int32 [L] tensor on "
                             "q's device")
    return B, L, H, KV, hd


def _lib():
    from repro_torch.kernels.build import load
    lib = load("decode_attention")
    if lib.decode_attention_launch.argtypes is None:
        fn = lib.decode_attention_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        cfg = lib.decode_attention_config
        cfg.restype = ctypes.c_int
        cfg.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def _counters(device, n):
    """n int32 ticket counters on ``device``, zero between launches (the
    kernel's last block of each (batch, kv head) resets its own); grown,
    never shrunk, and shared by the calls on one stream."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def decode_attention(q, k_cache, v_cache, pos: int, *, window=0, softcap=0.0,
                     scale=None, k_pos=None) -> torch.Tensor:
    """Attention of one token per row over the cache, [B, H, hd] in q's
    type.  On CUDA tensors this launches the kernel on the current stream;
    on CPU tensors it is ``decode_attention_plain``."""
    global LAUNCHES
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, pos, window=window,
                                      softcap=softcap, scale=scale,
                                      k_pos=k_pos)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    B, L, H, KV, hd = _check(q, k_cache, v_cache, pos, window, k_pos)
    pos = int(pos)
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if B == 0:
        return out
    lo, hi = slot_range(L, pos, window, k_pos)
    dev = q.device.index or 0
    cfg = tile_config(hd, q.dtype, H // KV, dev)
    per_warp, n_parts = decode_plan(hi - lo, B, KV, cfg["W"],
                                    cfg["blocks_per_sm"], cfg["sms"])
    part = torch.empty((B * KV, n_parts, H // KV, hd + 2) if n_parts > 1
                       else (1,), dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * KV)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_pos is None else k_pos.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), B, L, H, KV, hd,
        DTYPES[q.dtype], float(scale), pos, int(window), float(softcap), lo,
        hi, per_warp, n_parts, dev, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel failed to launch: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out


# ------------------------------------------------------- MLA (absorbed) decode

def mla_decode_attention_plain(q_lat, q_rope, ckv, krope, pos, scale):
    """MLA decode in plain PyTorch, float32 inside, out in q_lat's type:
    q_lat [B, H, C], q_rope [B, H, R], caches ckv [B, L, C] and krope [B,
    L, R] -> [B, H, C]."""
    s = (torch.einsum("bhc,blc->bhl", q_lat.float(), ckv.float())
         + torch.einsum("bhr,blr->bhl", q_rope.float(), krope.float())) \
        * scale
    ok = torch.arange(ckv.shape[1], device=ckv.device) <= pos
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,blc->bhc", p, ckv.float()).to(q_lat.dtype)


@functools.lru_cache(maxsize=None)
def mla_tile_config(dtype, device_index) -> dict:
    """The MLA kernel's tiling at ``dtype`` on CUDA device
    ``device_index``, as its library reports it (``mla_decode_config``):
    TS slots a tile, W warps a block, SMEM bytes of dynamic shared memory
    a block, ``blocks_per_sm`` resident blocks an SM, ``max_parts`` the
    most parts a batch row may take (bf16: a thread-block cluster's 16;
    float32: its merge's 1024), ``clusters`` (bf16) the clusters of n
    blocks resident at once for n = 1 .. 16, and ``sms``."""
    cfg = (ctypes.c_int * 21)()
    rc = _mla_lib().mla_decode_config(DTYPES[dtype], device_index, cfg)
    if rc != 0 or cfg[3] < 1:
        raise RuntimeError(f"mla_decode has no resident block in {dtype}: "
                           f"CUDA error {rc}")
    props = torch.cuda.get_device_properties(device_index)
    return {"TS": cfg[0], "W": cfg[1], "SMEM": cfg[2],
            "blocks_per_sm": cfg[3], "max_parts": cfg[4],
            "clusters": tuple(cfg[5:21]) if dtype == torch.bfloat16 else (),
            "sms": props.multi_processor_count}


@functools.lru_cache(maxsize=4096)
def mla_plan(n_slots, B, unit, max_parts, slots_on_card):
    """(slots a part, parts) of each batch row's ``n_slots`` kept slots:
    runs of whole ``unit``-slot tiles (the last part's run may end inside
    one), as many parts as give ``slots_on_card`` resident blocks (SMs
    times blocks an SM) one wave over the B rows, at most ``max_parts``
    and at most one a tile.  The bf16 kernel plans with its tile of 64
    slots and the largest cluster of which B fit on the card at once,
    float32 with 16-slot units and 1024 parts."""
    tiles = -(-n_slots // unit)
    want = max(1, min(max_parts, tiles, slots_on_card // B))
    per_part = unit * -(-tiles // want)
    return per_part, -(-n_slots // per_part)


def mla_max_parts(clusters, B):
    """The most parts a bf16 batch row may take: the largest cluster size
    n (``clusters[n - 1]`` clusters of n blocks resident at once, as
    ``mla_tile_config`` reports them) of which all B batch rows' clusters
    fit on the card at once; 1 where none does."""
    return max([n + 1 for n, c in enumerate(clusters) if c >= B] or [1])


def mla_launch_plan(dtype, device_index, n_slots, B):
    """(slots a part, parts) of the MLA kernel at ``dtype`` on the device:
    ``mla_plan`` with the library's tiling; bf16 takes at most
    ``mla_max_parts`` parts."""
    cfg = mla_tile_config(dtype, device_index)
    if dtype == torch.bfloat16:
        unit, max_parts = cfg["TS"], mla_max_parts(cfg["clusters"], B)
    else:
        unit, max_parts = 16, cfg["max_parts"]
    return mla_plan(n_slots, B, unit, max_parts,
                    cfg["sms"] * cfg["blocks_per_sm"])


def _mla_lib():
    from repro_torch.kernels.build import load
    lib = load("mla_decode")
    if lib.mla_decode_launch.argtypes is None:
        fn = lib.mla_decode_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        cfg = lib.mla_decode_config
        cfg.restype = ctypes.c_int
        cfg.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def _mla_check(q_lat, q_rope, ckv, krope, pos):
    ts = (("q_lat", q_lat), ("q_rope", q_rope), ("ckv", ckv),
          ("krope", krope))
    for name, t in ts:
        if t.device != q_lat.device:
            raise ValueError(f"{name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
        if t.dtype != q_lat.dtype:
            raise TypeError(f"{name} is {t.dtype}, q_lat is {q_lat.dtype}")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"3-D tensor, got {tuple(t.shape)}")
    if q_lat.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q_lat.dtype}")
    B, H, C = q_lat.shape
    L, R = ckv.shape[1], krope.shape[2]
    if tuple(q_rope.shape) != (B, H, R) or tuple(ckv.shape) != (B, L, C) \
            or tuple(krope.shape) != (B, L, R):
        raise ValueError(f"shapes disagree: q_lat {tuple(q_lat.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}, ckv "
                         f"{tuple(ckv.shape)}, krope {tuple(krope.shape)}")
    if (H, C, R) != MLA_SHAPE:
        raise ValueError(f"(heads, latent, rope) ({H}, {C}, {R}): the "
                         f"kernel takes {MLA_SHAPE}")
    if B > 65535 or B * L * C >= 2 ** 62:
        raise ValueError(f"cache shape {tuple(ckv.shape)} not taken")
    if isinstance(pos, torch.Tensor) or not 0 <= int(pos) < L:
        raise ValueError(f"pos must be a host int in [0, {L}), got {pos!r}")
    return B, L


def _mla_launch(q_lat, q_rope, ckv, krope, pos, scale, flags=0):
    """One call of the kernel (and, float32, its merge) on the current
    stream: the output [B, H, C].  ``flags`` 1 (bf16) skips the merge of
    the parts, which leaves the output unwritten: for timing the walk of
    the cache alone."""
    B, L = _mla_check(q_lat, q_rope, ckv, krope, pos)
    H, C, R = MLA_SHAPE
    out = torch.empty_like(q_lat)
    if B == 0:
        return out
    hi = int(pos) + 1
    dev = q_lat.device.index or 0
    per_part, n_parts = mla_launch_plan(q_lat.dtype, dev, hi, B)
    merged = q_lat.dtype == torch.float32 and n_parts > 1
    part = torch.empty((B * n_parts * H * (C + 2),) if merged else (1,),
                       dtype=torch.float32, device=q_lat.device)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    rc = _mla_lib().mla_decode_launch(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
        krope.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, L, C, R,
        DTYPES[q_lat.dtype], float(scale), hi, per_part, n_parts, flags,
        dev, stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode kernel failed to launch: CUDA "
                           f"error {rc}")
    return out


def mla_decode_attention(q_lat, q_rope, ckv, krope, pos: int,
                         scale: float) -> torch.Tensor:
    """MLA decode attention [B, H, C] in q_lat's type.  On CUDA tensors
    this launches the kernel on the current stream; on CPU tensors it is
    ``mla_decode_attention_plain``."""
    global MLA_LAUNCHES
    if q_lat.device.type == "cpu":
        return mla_decode_attention_plain(q_lat, q_rope, ckv, krope, pos,
                                          scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"no mla_decode_attention for device "
                         f"{q_lat.device}")
    out = _mla_launch(q_lat, q_rope, ckv, krope, pos, scale)
    MLA_LAUNCHES += 1
    return out
