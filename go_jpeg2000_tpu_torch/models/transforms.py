"""Device transform stages of the codec pipeline, as torch ops.

Port of go_jpeg2000_tpu/models/transforms.py: DC shift + RCT/ICT +
multi-level 5/3 or 9/7 DWT forward (+ deadzone quantization for 9/7), and
the inverse chain (midpoint dequantization for 9/7), for batches of frames
and, through run_forward and run_inverse, for one tile at its origin.  Each level goes through the hand-written CUDA kernel
(ops/dwt_cuda.py) when the tensor is on the card and `dwt_cuda.usable`
admits the level (every level at any origin and size), and through the
plain torch lifting (ops/dwt.py) otherwise; a CUDA level that takes the
plain version is counted in `dwt_cuda.PLAIN_LEVELS`.  A row shard's level
(edges given) always goes to the wrapper: the kernel on the card, the
plain halo form on the CPU, a ValueError where the halo form is not
defined.  The head (DC shift, RCT or ICT) and the tail (inverse RCT or
ICT, rounding, DC shift, clamp, narrowing) go through one launch each of
the kernels of ops/mct_cuda.py on the card, and through their plain torch
versions (coefficients_plain, samples_plain) on the CPU.  Components of
equal shape batch as [N, C, H, W] so one launch covers every frame and
component.  Nothing here falls back
to the CPU: tensors stay on the device they were given, and a failed
kernel build or launch raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import dwt, dwt_cuda, mct, mct_cuda, quant


def resolve_device(device) -> torch.device:
    """The torch.device to run on.  "cuda" without a card raises: the port
    never moves work to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but torch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_FORWARD_KERNEL = {dwt.REV53: dwt_cuda.forward_2d_53,
                   dwt.IRR97: dwt_cuda.forward_2d_97}
_INVERSE_KERNEL = {dwt.REV53: dwt_cuda.inverse_2d_53,
                   dwt.IRR97: dwt_cuda.inverse_2d_97}


def forward_level(x: torch.Tensor, kind: str, u0: int, v0: int, edges=None,
                  rank: int = 0) -> Dict[str, torch.Tensor]:
    """One level of x [N, H, W] at origin (u0, v0); row shard `rank` of a
    signal (origin even) passes every shard's edge slot, `edges`
    (dwt.forward_2d_halo)."""
    h, w = x.shape[-2:]
    if edges is not None or (x.is_cuda
                             and dwt_cuda.usable(h, w, u0, v0, kind)):
        return _FORWARD_KERNEL[kind](x, edges, rank, u0, v0)
    if x.is_cuda:
        dwt_cuda.count_plain_level()
    return dwt.forward_2d(x, kind, u0=u0, v0=v0)


def inverse_level(bands: Dict[str, torch.Tensor], kind: str, u0: int,
                  v0: int, edges=None, rank: int = 0) -> torch.Tensor:
    """Inverse of forward_level (dwt.inverse_2d_halo for a row shard)."""
    ll = bands["LL"]
    h = ll.shape[-2] + bands["LH"].shape[-2]
    w = ll.shape[-1] + bands["HL"].shape[-1]
    if edges is not None or (ll.is_cuda and dwt_cuda.usable(
            h, w, u0, v0, kind, inverse=True)):
        return _INVERSE_KERNEL[kind](bands, edges, rank, u0, v0)
    if ll.is_cuda:
        dwt_cuda.count_plain_level()
    return dwt.inverse_2d(bands, kind, u0=u0, v0=v0)


def _decompose(x: torch.Tensor, levels: int, kind: str, u0: int, v0: int
               ) -> List[Dict[str, torch.Tensor]]:
    """Multi-level decomposition of x [..., H, W], one level at a time on
    the flattened [N, H, W] batch (the same result as dwt.decompose)."""
    if levels == 0:
        return [{"LL": x}]
    lead = tuple(x.shape[:-2])
    n = int(np.prod(lead, dtype=np.int64))
    cur = x.reshape((n,) + tuple(x.shape[-2:]))
    out = []
    origins = dwt.level_origins(u0, v0, levels)
    for lev in range(1, levels + 1):
        bands = forward_level(cur, kind, *origins[lev - 1])
        entry = {k: bands[k].reshape(lead + tuple(bands[k].shape[-2:]))
                 for k in ("HL", "LH", "HH")}
        cur = bands["LL"].contiguous()
        if lev == levels:
            entry["LL"] = cur.reshape(lead + tuple(cur.shape[-2:]))
        out.append(entry)
    return out


def _reconstruct(pyramid: List[Dict[str, torch.Tensor]], kind: str,
                 u0: int, v0: int) -> torch.Tensor:
    """Inverse of _decompose (the same result as dwt.reconstruct).  A level
    past the tile's size has empty detail bands, which the block plans
    leave out of the decoders' pyramids (a top level of LL alone, as in a
    16x16 frame at 5 levels): they come back here as zero-size tensors."""
    levels = len(pyramid) if ("HL" in pyramid[-1] or len(pyramid) > 1) \
        else 0
    if levels == 0:
        return pyramid[0]["LL"]
    top = pyramid[levels - 1]["LL"]
    lead = tuple(top.shape[:-2])
    n = int(np.prod(lead, dtype=np.int64))

    def flat(t):
        return t.reshape((n,) + tuple(t.shape[-2:])).contiguous()

    origins = dwt.level_origins(u0, v0, levels)
    cur = flat(top)
    for lev in range(levels, 0, -1):
        entry = pyramid[lev - 1]
        h_ll, w_ll = cur.shape[-2:]
        hl = flat(entry["HL"]) if "HL" in entry else cur.new_zeros(
            (n, h_ll, 0))
        lh = flat(entry["LH"]) if "LH" in entry else cur.new_zeros(
            (n, 0, w_ll))
        hh = flat(entry["HH"]) if "HH" in entry else cur.new_zeros(
            (n, lh.shape[-2], hl.shape[-1]))
        cur = inverse_level({"LL": cur, "HL": hl, "LH": lh, "HH": hh}, kind,
                            *origins[lev - 1])
    return cur.reshape(lead + tuple(cur.shape[-2:]))


def upload(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host samples -> a tensor on `device`, shipped narrow.  uint8, int8,
    int16, uint16 and int32 travel as they are; uint32 travels as its int32
    bit pattern, which is its value below 2^31 (samples of up to 31 bits, as
    encoder.check_precision admits); other integer types are cast to int32
    on the host, wrapping as the JAX package's astype does.  coefficients
    widens the samples as it reads them (on the card mct_cuda.mct_forward,
    on the CPU coefficients_plain)."""
    batch = np.ascontiguousarray(batch)
    if batch.dtype == np.uint32:
        batch = batch.view(np.int32)
    elif batch.dtype not in (np.uint8, np.int8, np.int16, np.uint16,
                             np.int32):
        batch = batch.astype(np.int32)
    return torch.from_numpy(batch).to(device)


def coefficients(x: torch.Tensor, kind: str, use_mct: bool, precision: int,
                 signed: bool) -> torch.Tensor:
    """Samples [N, C, H, W] (as upload ships them) -> DC shift, then RCT
    (5/3, int32) or ICT (9/7, float32): the DWT's input.  On the card one
    launch of mct_cuda.mct_forward; on the CPU coefficients_plain."""
    if x.device.type == "cpu":
        return coefficients_plain(x, kind, use_mct, precision, signed)
    return mct_cuda.mct_forward(x, kind, use_mct, precision, signed)


def coefficients_plain(x: torch.Tensor, kind: str, use_mct: bool,
                       precision: int, signed: bool) -> torch.Tensor:
    """coefficients as torch ops (mct_forward's plain version)."""
    x = mct.dc_shift_forward(x.to(torch.int32), precision, signed)
    c = x.shape[1]
    if use_mct and c >= 3:
        fwd = mct.forward_rct if kind == dwt.REV53 else mct.forward_ict
        y, u, v = fwd(x[:, 0], x[:, 1], x[:, 2])
        x = torch.stack([y, u, v] + [x[:, i] for i in range(3, c)], dim=1)
    if kind == dwt.IRR97:
        x = x.to(torch.float32)
    return x


def forward_pyramid(x: torch.Tensor, levels: int, kind: str, use_mct: bool,
                    precision: int, signed: bool, u0: int, v0: int
                    ) -> List[Dict[str, torch.Tensor]]:
    """Samples [N, C, H, W] (as upload ships them) -> DC shift, RCT (5/3)
    or ICT (9/7, then float32) and the multi-level DWT: the pyramid,
    leaves [N, C, h, w] (int32 for 5/3, float32 for 9/7)."""
    return _decompose(coefficients(x, kind, use_mct, precision, signed),
                      levels, kind, u0, v0)


def forward_transform_batch(x: torch.Tensor, levels: int, kind: str,
                            use_mct: bool, precision: int, signed: bool,
                            u0: int, v0: int,
                            quant_deltas: Optional[Sequence[float]] = None
                            ) -> torch.Tensor:
    """Samples [N, C, H, W] (as upload ships them) -> the whole pyramid
    packed into one flat tensor in the JAX package's tree-leaves order
    (levels ascending; keys sorted: HH, HL, LH [, LL at the top level]).
    5/3 (RCT): narrowed to int16 when a lossless pyramid fits (precision
    <= 13).  9/7 (ICT, float32 lifting): with `quant_deltas`, one deadzone
    step per leaf in that order (encoder._leaf_deltas), the leaves are
    quantized on the device and come back as int32 indices, int16 when
    precision <= 10."""
    pyr = forward_pyramid(x, levels, kind, use_mct, precision, signed, u0,
                          v0)
    leaves = [entry[k] for entry in pyr for k in sorted(entry)]
    if quant_deltas is not None:
        d = torch.tensor(quant_deltas, dtype=torch.float32, device=x.device)
        flat = torch.cat([quant.quantize(leaf, d[i]).reshape(-1)
                          for i, leaf in enumerate(leaves)])
        return flat.to(torch.int16) if precision <= 10 else flat
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    if kind == dwt.REV53 and precision <= 13:
        flat = flat.to(torch.int16)
    return flat


def dispatch_forward_batch(batch: np.ndarray, levels: int, kind: str,
                           use_mct: bool, precision: int, signed: bool,
                           u0: int, v0: int, device,
                           quant_deltas: Optional[Sequence[float]] = None
                           ) -> torch.Tensor:
    """Upload the batch [N, C, H, W] in its narrow dtype and run the forward
    transform on `device`; returns the packed flat pyramid there."""
    return forward_transform_batch(upload(batch, torch.device(device)),
                                   levels, kind, use_mct, precision, signed,
                                   u0, v0, quant_deltas)


def fetch_forward_batch(dev_flat: torch.Tensor, n: int, c: int, h: int,
                        w: int, levels: int, u0: int, v0: int):
    """Copy the packed pyramid to the host, widen, and unflatten it to
    per-frame numpy pyramids (leaves [C, bh, bw])."""
    flat = dev_flat.cpu().numpy()
    if flat.dtype == np.int16:
        flat = flat.astype(np.int32)
    shapes = dwt.subband_shapes(h, w, levels, u0=u0, v0=v0)
    pyrs = [[] for _ in range(n)]
    pos = 0
    for lev_shapes in shapes:
        entries = [{} for _ in range(n)]
        for k in sorted(lev_shapes.keys()):
            bh, bw = lev_shapes[k]
            cnt = n * c * bh * bw
            block = flat[pos:pos + cnt].reshape(n, c, bh, bw)
            for i in range(n):
                entries[i][k] = block[i]
            pos += cnt
        for i in range(n):
            pyrs[i].append(entries[i])
    return pyrs


def inverse_pyramid(pyramid: List[Dict[str, torch.Tensor]], kind: str,
                    use_mct: bool, precision: int, signed: bool, u0: int,
                    v0: int) -> torch.Tensor:
    """The inverse chain's tail, shared by both decode branches: pyramid
    leaves [N, C, h, w] on the device (int32 for 5/3, float32 dequantized
    coefficients for 9/7) -> the inverse DWT, inverse RCT/ICT, rounding
    half to even (9/7), DC shift, clamp and narrowing; returned flat.
    16-bit output comes back as its int16 bit pattern (torch has no uint16
    arithmetic); the caller views it as uint16 on the host."""
    return samples(_reconstruct(pyramid, kind, u0, v0), kind, use_mct,
                   precision, signed).reshape(-1)


def samples(x: torch.Tensor, kind: str, use_mct: bool, precision: int,
            signed: bool, narrow: bool = True) -> torch.Tensor:
    """The inverse DWT's output [N, C, H, W] (int32 for 5/3, float32 for
    9/7) -> inverse RCT/ICT, rounding half to even (9/7), DC shift
    (unsigned samples), clamp to the precision's range and narrowing: int8
    or uint8 up to 8 bits, int16 for 9 to 16 (signed samples as they are,
    unsigned ones as their int16 bit pattern, torch having no uint16
    arithmetic), int32 above 16 bits and with narrow=False.  On the card
    one launch of mct_cuda.mct_inverse; on the CPU samples_plain."""
    if x.device.type == "cpu":
        return samples_plain(x, kind, use_mct, precision, signed, narrow)
    return mct_cuda.mct_inverse(x, kind, use_mct, precision, signed, narrow)


def samples_plain(x: torch.Tensor, kind: str, use_mct: bool, precision: int,
                  signed: bool, narrow: bool = True) -> torch.Tensor:
    """samples as torch ops (mct_inverse's plain version)."""
    lossy = kind == dwt.IRR97
    c = x.shape[1]
    if use_mct and c >= 3:
        inv = mct.inverse_ict if lossy else mct.inverse_rct
        r, g, b = inv(x[:, 0], x[:, 1], x[:, 2])
        x = torch.stack([r, g, b] + [x[:, i] for i in range(3, c)], dim=1)
    if lossy:
        x = torch.round(x).to(torch.int32)    # half to even, as jnp.rint
    x = mct.dc_shift_inverse(x, precision, signed)
    x = mct.clamp_to_precision(x, precision, signed)
    return x.to(mct.narrow_dtype(precision, signed, narrow))


def inverse_transform_batch(flat: torch.Tensor, n: int, c: int, levels: int,
                            kind: str, use_mct: bool, precision: int,
                            signed: bool, u0: int, v0: int,
                            flat_shapes: Tuple = (),
                            leaf_deltas: Tuple = ()) -> torch.Tensor:
    """Batched inverse: the flat upload of pyramid leaves [N, C, h, w]
    (`flat_shapes`: (level, band, h, w) in upload order) -> reconstructed
    samples [N, C, H, W], clamped and narrowed, returned flat
    (inverse_pyramid).  9/7 leaves are quantizer indices, dequantized at the
    midpoint with `leaf_deltas` (per leaf in upload order, one step per
    component) before the float32 inverse."""
    lossy = kind == dwt.IRR97
    if lossy:
        deltas = torch.tensor(leaf_deltas, dtype=torch.float32,
                              device=flat.device).reshape(-1, 1, c, 1, 1)
    pyramid: List[Dict[str, torch.Tensor]] = [dict() for _ in range(levels)]
    pos = 0
    for i, (lev, band, h, w) in enumerate(flat_shapes):
        cnt = n * c * h * w
        # leaves may arrive narrowed (int16) to cut h2d bytes; widen here
        leaf = flat[pos:pos + cnt].reshape(n, c, h, w).to(torch.int32)
        pyramid[lev][band] = (quant.dequantize(leaf, deltas[i]) if lossy
                              else leaf)
        pos += cnt
    return inverse_pyramid(pyramid, kind, use_mct, precision, signed, u0, v0)


def dispatch_inverse_stacked(stacked, n: int, c: int, levels: int, kind: str,
                             use_mct: bool, precision: int, signed: bool,
                             u0: int, v0: int, device,
                             deltas=None) -> torch.Tensor:
    """Pre-stacked numpy leaves [N, C, h, w] -> one flat upload to `device`
    -> inverse_transform_batch.  5/3 leaves travel as int16 when a lossless
    pyramid fits; 9/7 leaves are quantizer indices and travel as int32, with
    `deltas` shaped like `stacked` (per level, band -> one step per
    component)."""
    narrow = kind == dwt.REV53 and precision <= 13
    dt = np.int16 if narrow else np.int32
    flat_shapes = []
    leaf_deltas = []
    chunks = []
    for lev in range(len(stacked)):
        for k in sorted(stacked[lev]):
            a = stacked[lev][k].astype(dt)
            flat_shapes.append((lev, k) + a.shape[-2:])
            if kind == dwt.IRR97:
                leaf_deltas.append(tuple(deltas[lev][k]))
            chunks.append(a.reshape(-1))
    flat = torch.from_numpy(np.concatenate(chunks)).to(torch.device(device))
    return inverse_transform_batch(flat, n, c, levels, kind, use_mct,
                                   precision, signed, u0, v0,
                                   tuple(flat_shapes), tuple(leaf_deltas))


def _tree_leaves(pyr) -> List[torch.Tensor]:
    """The pyramid's leaves in the JAX package's tree-leaves order (levels
    ascending; keys sorted: HH, HL, LH [, LL at the top level])."""
    return [entry[k] for entry in pyr for k in sorted(entry)]


def run_forward(tile_data: Sequence[np.ndarray], levels: int, kind: str,
                use_mct: bool, precision: int, signed: bool, u0: int,
                v0: int, device,
                quant_deltas: Optional[Sequence[float]] = None):
    """One tile's forward transform (the JAX package's run_forward): the
    components [h, w] at the tile-component origin (u0, v0), uploaded in
    their narrow dtype, DC shift, RCT or ICT, the DWT levels on `device`
    (forward_level: the level kernels on the card), and, with
    `quant_deltas` (one step per leaf in tree-leaves order,
    encoder._leaf_deltas), the deadzone quantization there too.  Returns
    the pyramid as numpy leaves [C, bh, bw] per level (int32 coefficients
    or quantizer indices, float32 coefficients for 9/7 without deltas)."""
    comps = np.stack(tile_data)[None]
    c, h, w = comps.shape[1:]
    x = upload(comps, torch.device(device))
    pyr = forward_pyramid(x, levels, kind, use_mct, precision, signed, u0, v0)
    leaves = _tree_leaves(pyr)
    if quant_deltas is not None:
        d = torch.tensor(quant_deltas, dtype=torch.float32, device=x.device)
        leaves = [quant.quantize(leaf, d[i]) for i, leaf in enumerate(leaves)]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    return fetch_forward_batch(flat, 1, c, h, w, levels, u0, v0)[0]


def run_inverse(pyramid, kind: str, use_mct: bool, precision: int,
                signed: bool, u0: int, v0: int, device) -> np.ndarray:
    """One tile's inverse transform (the JAX package's run_inverse): numpy
    leaves [C, bh, bw] per level (int32 for 5/3, dequantized float32 for
    9/7; the top level holds LL, a pyramid of no level is [{"LL": ..}]) at
    the tile-component origin (u0, v0), uploaded to `device`,
    the inverse DWT levels (inverse_level: the level kernels on the card),
    inverse RCT or ICT, rounding (9/7), DC shift and clamp.  Returns int32
    samples [C, H, W] on the host."""
    dev = torch.device(device)
    dt = torch.int32 if kind == dwt.REV53 else torch.float32
    pyr = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev).to(dt)[None]
            for k, v in entry.items()} for entry in pyramid]
    x = samples(_reconstruct(pyr, kind, u0, v0), kind, use_mct, precision,
                signed, narrow=False)
    return x[0].cpu().numpy()
