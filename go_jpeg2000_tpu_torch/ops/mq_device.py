"""Lockstep MQ coder over many code-blocks: the plain torch version.

Port of go_jpeg2000_tpu/ops/mq_device.py.  Every lane (one code-block) runs
the ISO/IEC 15444-1 C.3 encoder over its own decision stream (ctx | bit << 5
per byte): per-lane A, C and CT registers and 19 context states, the
BYTEOUT carry and 0xFF stuffing, and the OpenJPEG-compatible FLUSH, as
masked vector ops, one decision of every lane per step.  Renormalization is
closed-form: the shift count s = clz16(A) is applied in at most three
chunks bounded by CT, a BYTEOUT firing whenever CT reaches 0.

Registers live in int64 and are masked to 32 bits: torch on the CPU has no
uint32 shifts or compares.  Each step commits 0 to 3 bytes per lane into a
dense staging row at static columns; `compact_rows` and `pool_rows` turn
the staging rows into each lane's segment and one byte pool.

Feeding a stream through ops/mq.MQEncoder gives the same segment
(tests/test_torch_ebcot.py).  ops/ebcot_cuda.py runs the CUDA kernels of
the same chain (csrc/ebcot_enc.cu) for tensors on the card.
`stress_streams` builds the decision streams that the tests and
chip_smoke.py hold every version of the coder to.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .mq import CTX_RL, CTX_UNI, CTX_ZC_BASE, NUM_CONTEXTS, QE_TABLE

M32 = 0xFFFFFFFF
M16 = 0xFFFF

# Table C.2 as one [47, 4] table: Qe, NMPS, NLPS, SWITCH
_TABLE = np.asarray(QE_TABLE, np.int64)

# initial context states (Table D.7): all 0 except UNI = 46, RL = 3, ZC0 = 4
_I0 = np.zeros(NUM_CONTEXTS, np.int64)
_I0[CTX_UNI] = 46
_I0[CTX_RL] = 3
_I0[CTX_ZC_BASE] = 4

UNROLL = 8                     # decisions per step of the staging layout


def _byteout(last, c, ct, pos, mask):
    """Masked BYTEOUT (C.3.2) on the register model: the buffer's last byte
    lives in `last`; each byteout commits the old last byte and loads a new
    one.  Returns (last, c, ct, pos, committed byte, committed)."""
    stuffed = last == 0xFF
    carry = (~stuffed) & (c >= 0x8000000)
    last1 = last + carry.to(torch.int64)
    stuff2 = carry & (last1 == 0xFF)
    commit = torch.where(stuffed, last, last1)
    c2 = torch.where(stuff2, c & 0x7FFFFFF, c)
    use_stuff = stuffed | stuff2
    newlast = torch.where(use_stuff, (c2 >> 20) & 0xFF, (c2 >> 19) & 0xFF)
    newc = torch.where(use_stuff, c2 & 0xFFFFF, c2 & 0x7FFFF)
    newct = torch.where(use_stuff, torch.full_like(ct, 7),
                        torch.full_like(ct, 8))
    last = torch.where(mask, newlast, last)
    c = torch.where(mask, newc, c)
    ct = torch.where(mask, newct, ct)
    pos = pos + mask.to(torch.int64)
    return last, c, ct, pos, commit.to(torch.uint8), mask


def _bit_length16(a):
    """Bit length of a in [1, 0xFFFF] (exact: float64 holds it)."""
    return torch.frexp(a.to(torch.float64)).exponent.to(a.dtype)


def _one_decision(st, x, active, table):
    """One ENCODE (C.3.1) across all lanes; x = ctx | bit << 5.  Returns
    (state, [(byte, committed)] * 3); a byteout no lane makes is left
    out."""
    a, c, ct, last, pos, I, MPS = st
    xi = x.to(torch.int64)
    ctx = (xi & 0x1F).clamp(max=NUM_CONTEXTS - 1)[:, None]
    d = xi >> 5
    idx = I.gather(1, ctx)[:, 0]
    mps = MPS.gather(1, ctx)[:, 0]
    qe, nmps, nlps, sw = table[idx].unbind(1)

    is_mps = d == mps
    a1 = a - qe
    renorm_mps = is_mps & ((a1 & 0x8000) == 0)
    a_lt = a1 < qe
    new_a = torch.where(is_mps, torch.where(renorm_mps & a_lt, qe, a1),
                        torch.where(a_lt, a1, qe))
    add_c = torch.where((is_mps & ~(renorm_mps & a_lt)) | (~is_mps & a_lt),
                        qe, torch.zeros_like(qe))
    new_idx = torch.where(renorm_mps, nmps, torch.where(~is_mps, nlps, idx))
    new_mps = torch.where(~is_mps & (sw > 0), 1 - mps, mps)

    a = torch.where(active, new_a, a)
    c = torch.where(active, (c + add_c) & M32, c)
    # inactive lanes write their context's state back unchanged
    I.scatter_(1, ctx, torch.where(active, new_idx, idx)[:, None])
    MPS.scatter_(1, ctx, torch.where(active, new_mps, mps)[:, None])

    # renormalization shifts A until bit 15 sets: s = 16 - bitlen(A) in
    # [0, 15], and s >= 1 whenever a renormalization is due
    need = (renorm_mps | ~is_mps) & active
    s = torch.where(need, 16 - _bit_length16(a), torch.zeros_like(a))
    a = torch.where(need, (a << s) & M16, a)

    outs = []
    for _ in range(3):
        act_r = s > 0
        if not bool(act_r.any()):
            break
        s1 = torch.minimum(s, ct)
        c = torch.where(act_r, (c << s1) & M32, c)
        ct = torch.where(act_r, ct - s1, ct)
        s = torch.where(act_r, s - s1, s)
        do_bo = act_r & (ct == 0)
        if bool(do_bo.any()):
            last, c, ct, pos, by, vd = _byteout(last, c, ct, pos, do_bo)
            outs.append((by, vd))
    return (a, c, ct, last, pos, I, MPS), outs


def _flush(st, has_any):
    """FLUSH (C.3.4): SETBITS, two byteouts and the final last byte, masked
    by has_any (lanes without decisions emit nothing).  Returns (commits,
    lens); lens leaves out the sentinel commit, and the trailing 0xFF is
    stripped by the caller."""
    a, c, ct, last, pos, I, MPS = st
    tempc = (c + a - 1) & M32
    c1 = c | 0xFFFF
    c1 = torch.where(c1 >= tempc, c1 - 0x8000, c1)
    c = torch.where(has_any, c1, c)
    outs = []
    for _ in range(2):
        c = torch.where(has_any, (c << ct) & M32, c)
        last, c, ct, pos, by, vd = _byteout(last, c, ct, pos, has_any)
        outs.append((by, vd))
    outs.append((last.to(torch.uint8), has_any))
    pos = pos + has_any.to(torch.int64)
    lens = torch.clamp(pos - 1, min=0)      # drop the sentinel commit
    return outs, lens


def mq_encode_scan(xs_tm: torch.Tensor, n_dec: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xs_tm: [steps, UNROLL, B] uint8 decision streams (ctx | bit << 5,
    time-major, padded); n_dec: [B] true decision counts.

    Returns (stage_bytes uint8 [B, S], stage_valid bool [B, S], lens int32
    [B]) with S = steps * UNROLL * 3 + 3: commits in column order, the
    first commit of each lane being the discarded sentinel."""
    steps, U, B = xs_tm.shape
    assert U == UNROLL
    dev = xs_tm.device
    table = torch.from_numpy(_TABLE).to(dev)
    i64 = torch.int64
    st = (torch.full((B,), 0x8000, dtype=i64, device=dev),
          torch.zeros(B, dtype=i64, device=dev),
          torch.full((B,), 12, dtype=i64, device=dev),
          torch.zeros(B, dtype=i64, device=dev),     # sentinel byte 0
          torch.zeros(B, dtype=i64, device=dev),
          torch.from_numpy(_I0).to(dev).repeat(B, 1),
          torch.zeros((B, NUM_CONTEXTS), dtype=i64, device=dev))
    S = steps * U * 3 + 3
    n_dec = n_dec.to(i64).to(dev)
    xs = xs_tm.reshape(steps * U, B)
    cols, bys, vds = [], [], []
    for g in range(min(steps * U, int(n_dec.max()) if B else 0)):
        st, outs = _one_decision(st, xs[g], g < n_dec, table)
        for k, (by, vd) in enumerate(outs):
            cols.append(3 * g + k)
            bys.append(by)
            vds.append(vd)
    fl, lens = _flush(st, n_dec > 0)
    for k, (by, vd) in enumerate(fl):
        cols.append(steps * U * 3 + k)
        bys.append(by)
        vds.append(vd)
    sb = torch.zeros((B, S), dtype=torch.uint8, device=dev)
    sv = torch.zeros((B, S), dtype=torch.bool, device=dev)
    idx = torch.tensor(cols, dtype=i64, device=dev)
    sb[:, idx] = torch.stack(bys, dim=1)
    sv[:, idx] = torch.stack(vds, dim=1)
    return sb, sv, lens.to(torch.int32)


def compact_rows(vals: torch.Tensor, valid: torch.Tensor, cap: int,
                 drop_first: bool = False) -> torch.Tensor:
    """Per-row stable compaction of the valid entries: [B, cap] rows,
    left-justified (drop_first skips each row's first valid entry, the MQ
    sentinel commit).  Entries past a row's count are its invalid entries in
    their order, then zeros."""
    B, S = vals.shape
    col = torch.arange(S, device=vals.device).expand(B, S)
    key = torch.where(valid, col, torch.full_like(col, 2 ** 30))
    order = torch.sort(key, dim=1, stable=True).indices
    sv = vals.gather(1, order)
    lo = 1 if drop_first else 0
    out = sv[:, lo:lo + cap]
    if out.shape[1] < cap:
        out = torch.cat([out, out.new_zeros((B, cap - out.shape[1]))], dim=1)
    return out


def pool_rows(rows: torch.Tensor, lens: torch.Tensor,
              cap_pool: int) -> torch.Tensor:
    """Rows [B, W] of the given lengths concatenated into one pool
    [cap_pool] (zero-padded past the sum of lens); each row starts at the
    exclusive prefix sum of lens."""
    B, W = rows.shape
    local = torch.arange(W, device=rows.device).expand(B, W)
    pool = rows[local < lens.to(torch.int64).view(B, 1)][:cap_pool]
    if pool.numel() < cap_pool:
        pool = torch.cat([pool, pool.new_zeros(cap_pool - pool.numel())])
    return pool


def encode_streams(streams: List[bytes]) -> List[bytes]:
    """The chain as the device path runs it, on host byte streams: pack,
    scan, compact, pool and cut into segments, each with its trailing 0xFF
    stripped.  For tests."""
    B = len(streams)
    ndec = np.asarray([len(s) for s in streams], np.int64)
    t_cap = max(UNROLL, -(-int(ndec.max(initial=0)) // UNROLL) * UNROLL)
    aligned = np.full((B, t_cap), 0xFF, np.uint8)
    for i, s in enumerate(streams):
        aligned[i, :len(s)] = np.frombuffer(bytes(s), np.uint8)
    xs_tm = torch.from_numpy(aligned.T.copy()).reshape(t_cap // UNROLL,
                                                       UNROLL, B)
    sb, sv, lens = mq_encode_scan(xs_tm, torch.from_numpy(ndec))
    rows = compact_rows(sb, sv, 3 * t_cap + 3, drop_first=True)
    lens_np = lens.numpy().astype(np.int64)
    pool = pool_rows(rows, lens, int(lens_np.sum())).numpy()
    ends = np.cumsum(lens_np)
    out = []
    for i in range(B):
        seg = bytes(pool[ends[i] - lens_np[i]:ends[i]])
        out.append(seg[:-1] if seg and seg[-1] == 0xFF else seg)
    return out


def stress_streams(chunk: int, seed: int = 0) -> List[bytes]:
    """Decision streams (ctx | bit << 5) that stress an MQ coder which
    stages its input in chunks of `chunk` bytes: lengths 0, 1, chunk - 1,
    chunk, chunk + 1 and 2 * chunk + 1 after streams of odd lengths (so
    pool offsets fall off 16-byte boundaries); long MPS runs in one context
    (it reaches the most skewed state and codes thousands of decisions
    without a byte); fair bits in the uniform context (a byte every 8
    decisions or so: 0xFF bytes, stuffing, carries into a 0xFF byte);
    EBCOT-like mixes of all 19 contexts with a bias each; and a last
    stream twenty times the next longest.  The same seed gives the same
    streams."""
    rng = np.random.RandomState(seed)

    def mixed(n):
        cx = rng.randint(0, NUM_CONTEXTS, n)
        p1 = rng.uniform(0.02, 0.5, NUM_CONTEXTS)
        return (cx | (rng.random_sample(n) < p1[cx]) << 5).astype(
            np.uint8).tobytes()

    def fair(n):
        return (CTX_UNI | rng.randint(0, 2, n) << 5).astype(
            np.uint8).tobytes()

    def mps_run(n, cx=CTX_ZC_BASE):
        return bytes([cx]) * n

    streams = [b"", mixed(1), mixed(3), b"", fair(7), mixed(chunk - 1),
               fair(chunk), mixed(chunk + 1), mixed(2 * chunk + 1),
               mps_run(3 * chunk + 5), mixed(5) + mps_run(2 * chunk, CTX_RL)
               + mixed(501), fair(2 * chunk + 3), mixed(9) + fair(chunk + 7),
               mps_run(chunk - 1, 9) + fair(chunk // 2 + 1)]
    longest = max(map(len, streams))
    parts = []
    while sum(map(len, parts)) < 20 * longest:
        parts.append(fair(rng.randint(1, 4 * chunk)) if rng.rand() < 0.5
                     else mixed(rng.randint(1, 4 * chunk)))
    return streams + [b"".join(parts)]


def pool_of(streams: List[bytes], device="cpu", base_offset: int = 0):
    """compact_rows' outputs for host decision streams: (pool uint8 [sum],
    ndec int32, off int64, largest).  base_offset > 0 makes the pool a view
    that starts that many bytes into its allocation."""
    ndec = np.asarray([len(x) for x in streams], np.int64)
    buf = np.zeros(base_offset + int(ndec.sum()), np.uint8)
    buf[base_offset:] = np.frombuffer(b"".join(streams), np.uint8)
    pool = torch.from_numpy(buf).to(device)[base_offset:]
    return (pool, torch.from_numpy(ndec.astype(np.int32)).to(device),
            torch.from_numpy(np.cumsum(ndec) - ndec).to(device),
            int(ndec.max(initial=0)))
