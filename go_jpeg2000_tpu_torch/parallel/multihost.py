"""Multi-host decomposition of the encode and decode (BASELINE config 5).

Port of go_jpeg2000_tpu/parallel/multihost.py.  Each "host" is a separate
OS process that sees only its own tiles; a pipe-based reduction server in
the parent stands in for the cross-host network:

    host h:  tiles {t : t % n_hosts == h}
             transform (on the host's device) + block coding (host)
             PCRD hulls                       (host-local)
             allreduce(sum/max/min), O(log) rounds   <-- the only
             Tier-2 of its tiles              (host-local)   cross-host talk
    gather:  the parent orders the tile-parts by tile index, adds the main
             header and EOC

The codestream is byte-identical to models.encoder.encode: every PCRD
decision depends only on globally reduced scalars, so every host derives
the same thresholds (models/rate.assign_layers_sharded), and the budget-fit
loop reduces the assembled sizes the same way
(models/encoder._assemble_with_budget with size_reduce).  Decode needs no
reduction: each host decodes its tiles (decoder.tile_pyramids, then
_inverse_tile on its device) and the parent places the pixels.

Every host runs its tiles' transforms on the device it is given: with
device "cuda" and several cards host h takes cuda:{h % count}, with one
card every host shares it; "cuda" without a card raises in the parent,
before any process starts.  The parent builds the CUDA libraries and the
native coder before it spawns the hosts ("spawn": no fork after CUDA
starts), so no host compiles.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..codestream.parser import Parser
from ..models import decoder as dec
from ..models import encoder as enc
from ..models import rate as rate_mod
from ..models import transforms
from ..models.entropy_backend import require_native
from ..ops import cuda_build, kernel_launches
from ..options import Config, default_options
from ..tcd import geometry as geo


class PipeComm:
    """allreduce(vec, op) for one host: ships the host-local scalar to the
    reduction server over a Pipe and blocks for the global result; every
    call is one round trip, the traffic a multi-host PCRD pays per
    bisection probe."""

    def __init__(self, conn):
        self.conn = conn
        self.rounds = 0

    def __call__(self, vec, op: str):
        v = np.asarray(vec, np.float64)
        if op == "sum":
            local = float(v.sum())
        elif op == "max":
            local = float(v.max()) if v.size else -math.inf
        else:
            local = float(v.min()) if v.size else math.inf
        self.conn.send(("reduce", op, local))
        self.rounds += 1
        return self.conn.recv()


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The kernel launches of this process since `before` (kernel_launches
    then): a measured run's own, without its warm-ups."""
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _host_gate(opts) -> None:
    if opts.enable_ppm or opts.enable_tlm:
        raise ValueError("encode_multihost: PPM/TLM need a header-side "
                         "gather; disable them for multi-host encodes")


def host_encode_local(image: np.ndarray, opts, host_id: int, n_hosts: int,
                      comm, device="cuda") -> List[Tuple[int, bytes]]:
    """One host's half of the encode for the tiles it owns (t % n_hosts ==
    host_id): the transforms on `device`, block coding, the distributed
    PCRD through `comm(vec, op)` (the cross-host scalar allreduce) and
    Tier-2.  Returns [(tile index, tile-part bytes)]."""
    opts = opts or default_options()
    _host_gate(opts)
    dev = transforms.resolve_device(device)
    image = np.asarray(image)
    comps = enc._image_components(image)
    header, main = enc.header_and_main(image, opts)
    precision = header.components[0].precision
    signed = header.components[0].signed
    num_layers = header.coding_style.num_layers
    rate_budget = rate_mod.byte_budget(image, opts)

    my_tiles = [t for t in range(header.num_tiles) if t % n_hosts == host_id]
    states = []
    blocks = []
    weights: List[float] = []
    cw_mct = enc.mct_comp_weights(header, opts.lossless, len(comps))
    for t_idx in my_tiles:
        tile, enc_state, job_slots, results = enc._tile_entropy(
            header, comps, t_idx, opts, precision, signed, num_layers,
            rate_budget, dev)
        b, w = enc._build_blocks(job_slots, results, num_layers,
                                 opts.lossless, cw_mct)
        blocks += b
        weights += w
        states.append((tile, enc_state))

    tile_parts, _ppm = enc._assemble_with_budget(
        header, opts, states, blocks, num_layers, rate_budget, main,
        lambda target: rate_mod.assign_layers_sharded(
            [blocks], [weights], num_layers, target, allreduce=comm),
        size_reduce=lambda local: comm(np.asarray([float(local)]), "sum"),
        tile_ids=my_tiles)
    return list(zip(my_tiles, tile_parts))


def _parse_for_hosts(data: bytes):
    """(header, tile-parts by tile index, codestream) of a raw J2K
    codestream; a JP2 file raises (its colour conversion is a whole-image
    stage)."""
    _fmt, codestream, jp2 = dec.sniff_format(data)
    if jp2 is not None:
        raise ValueError("decode_multihost: raw J2K codestreams only "
                         "(colorspace conversion is a whole-image stage)")
    parser = Parser(codestream)
    header = parser.read_header()
    parts_by_tile: Dict[int, list] = {}
    for tp in parser.read_all_tile_parts(header):
        parts_by_tile.setdefault(tp.tile_index, []).append(tp)
    return header, parts_by_tile, codestream


def host_decode_local(data: bytes, config, host_id: int, n_hosts: int,
                      device="cuda") -> List[Tuple[int, np.ndarray]]:
    """One host's half of the decode: the whole per-tile chain (Tier-2 and
    block decoding on the host, the inverse transforms on `device`) for the
    tiles it owns, with the Config's quality layers.  As in
    decoder._decode_tiles, a tile of a tiled image whose data are corrupt
    is left out (it stays zero), a single tile's raises, and every other
    error raises.  Returns [(tile index, samples [C, th, tw] in the decoded
    image's dtype, decoder.image_dtype)]."""
    config = config or Config()
    dev = transforms.resolve_device(device)
    header, parts_by_tile, codestream = _parse_for_hosts(data)
    require_native()
    multi_tile = len(parts_by_tile) > 1
    dt = _image_dtype(header)
    out = []
    for t in sorted(parts_by_tile):
        if t % n_hosts != host_id:
            continue
        parts = parts_by_tile[t]
        tile = geo.build_tile(header, t,
                              parts[0] if parts[0].coding_style else None)
        try:
            pyramids = dec.tile_pyramids(header, tile, parts, codestream,
                                         config)
        except dec.CORRUPT_DATA_ERRORS:
            if not multi_tile:
                raise
            continue
        comps = dec._inverse_tile(header, tile, pyramids, dev)
        out.append((t, np.stack(comps).astype(dt)))
    return out


def _image_dtype(header):
    """The decoded image's dtype, as decode returns it."""
    return dec.image_dtype(header.components[0].precision,
                           header.components[0].signed)


# bytes a pipe message carries at most: a large object crosses in pieces of
# this size (_send_large).  On an 8-core H100 host the int32 samples of a
# 2-host 4096^2 RGB decode (201 MB) crossed the pipes in 3.1 s as one
# message a host and in 0.41 s in 1 MB pieces (chip_smoke.py, gather_ms)
PIPE_CHUNK = 1 << 20


def _send_large(conn, obj) -> None:
    blob = memoryview(pickle.dumps(obj))
    n = -(-len(blob) // PIPE_CHUNK)
    conn.send(n)
    for i in range(n):
        conn.send_bytes(blob[i * PIPE_CHUNK:(i + 1) * PIPE_CHUNK])


def _recv_large(conn):
    n = conn.recv()
    return pickle.loads(b"".join(conn.recv_bytes() for _ in range(n)))


def _child_main(conn) -> None:
    try:
        payload = _recv_large(conn)
        op, device = payload[0], payload[-1]
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)     # the hosts share the CPU's cores
        # start barrier: the timed run excludes interpreter start-up and
        # imports (a real host's process is long-lived); warm-up rounds also
        # exclude first-call library loads
        conn.send(("ready",))
        assert conn.recv() == "go"
        if op == "encode":
            (_, image, opts, host_id, n_hosts, warmups, device) = payload
            comm = PipeComm(conn)
            for _ in range(warmups):
                host_encode_local(image, opts, host_id, n_hosts, comm, device)
                conn.send(("warm",))
                assert conn.recv() == "go"
            before = kernel_launches()
            parts = host_encode_local(image, opts, host_id, n_hosts, comm,
                                      device)
            rounds = comm.rounds
        else:
            (_, data, config, host_id, n_hosts, warmups, device) = payload
            for _ in range(warmups):
                host_decode_local(data, config, host_id, n_hosts, device)
                conn.send(("warm",))
                assert conn.recv() == "go"
            before = kernel_launches()
            parts = host_decode_local(data, config, host_id, n_hosts, device)
            rounds = 0
        conn.send(("parts", rounds, _launches_since(before)))
        _send_large(conn, parts)
    except Exception as e:  # the traceback goes to the parent
        import traceback
        conn.send(("error", f"{e!r}\n{traceback.format_exc()}"))
    finally:
        conn.close()


def _prepare(device) -> Callable[[int], str]:
    """Resolve `device` in the parent (raising there for "cuda" without a
    card), build the CUDA libraries and the native coder once, and return
    host -> its device string: an unindexed "cuda" spreads the hosts over
    the cards, host h on cuda:{h % count}."""
    dev = transforms.resolve_device(device)
    require_native()
    if dev.type == "cuda":
        cuda_build.build()
        if dev.index is None:
            count = torch.cuda.device_count()
            return lambda h: f"cuda:{h % count}"
    return lambda h: str(dev)


def encode_multihost(image: np.ndarray, opts=None, n_hosts: int = 2,
                     _stats: Optional[dict] = None, warmups: int = 0,
                     device="cuda") -> bytes:
    """Encode with `n_hosts` separate OS processes, each owning its tiles
    end to end, reduction-server pipes standing in for the cross-host
    network; byte-identical to models.encoder.encode.  warmups > 0 runs
    that many throwaway encodes in the hosts first, so that
    _stats["compute_wall_s"] measures the steady state.  _stats also gets
    "reduce_rounds", "gathered_bytes", the machine's "cpu_count" (the
    hosts share its cores for block coding) and "host_launches": the CUDA
    kernel launches of the measured run alone, summed over the hosts
    (kernel_launches in each host; one host runs in this process)."""
    opts = opts or default_options()
    _host_gate(opts)
    image = np.asarray(image)
    enc.header_and_main(image, opts)    # check_precision before any spawn
    host_device = _prepare(device)
    if n_hosts <= 1:
        # one host: its half runs inline, with the numpy reducer
        parts = _run_inline(
            lambda: host_encode_local(image, opts, 0, 1,
                                      rate_mod._np_allreduce,
                                      host_device(0)),
            warmups, _stats)
    else:
        parts = _run_hosts(
            lambda h: ("encode", image, opts, h, n_hosts, warmups,
                       host_device(h)),
            n_hosts, warmups, _stats)
    return _finalize(image, opts, parts, _stats)


def _run_inline(run: Callable[[], list], warmups: int,
                _stats: Optional[dict]) -> list:
    """One host's half in this process: `warmups` throwaway runs, then the
    measured one, its wall time, rounds (none: the numpy reducer) and
    kernel launches in _stats as _run_hosts records them."""
    for _ in range(warmups):
        run()
    before = kernel_launches()
    t0 = time.perf_counter()
    parts = run()
    if _stats is not None:
        _stats["compute_wall_s"] = time.perf_counter() - t0
        _stats["reduce_rounds"] = 0
        _stats["host_launches"] = _launches_since(before)
    return parts


def _run_hosts(payload_for, n_hosts: int, warmups: int,
               _stats: Optional[dict]):
    """Spawn n_hosts processes, serve their reductions, gather their
    per-tile results (by host, then tile order within a host).  A host's
    error terminates every host and raises."""
    ctx = mp.get_context("spawn")
    conns = []
    procs = []

    def stop_all():
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)

    try:
        for h in range(n_hosts):
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(target=_child_main, args=(child_conn,),
                            daemon=True)
            p.start()
            child_conn.close()
            procs.append(p)
            conns.append(parent_conn)
            _send_large(parent_conn, payload_for(h))

        results: Dict[int, list] = {}
        launches: Dict[str, int] = {}
        rounds = 0

        def recv(h):
            try:
                msg = conns[h].recv()
            except EOFError:
                raise RuntimeError(f"multihost host {h} exited (code "
                                   f"{procs[h].exitcode}) without a result")
            if msg[0] == "error":
                raise RuntimeError(f"multihost host {h} failed: {msg[1]}")
            return msg

        def serve_until(tag: str) -> None:
            """Reduction server: every host sends one (op, local) a round
            in lockstep (each runs the same globally driven control flow),
            until every host has sent `tag`."""
            nonlocal rounds
            active = set(range(n_hosts))
            pend: List[Tuple[int, str, float]] = []
            while active:
                pend.clear()
                for h in sorted(active):
                    msg = recv(h)
                    if msg[0] == tag:
                        if tag == "parts":
                            results[h] = _recv_large(conns[h])
                            for k, v in msg[2].items():
                                launches[k] = launches.get(k, 0) + v
                        active.discard(h)
                    else:
                        pend.append((h, msg[1], msg[2]))
                if pend:
                    op = pend[0][1]
                    assert all(o == op for _, o, _ in pend), "reduce op skew"
                    vals = [v for _, _, v in pend]
                    if op == "sum":
                        # integer-exact, order-free sum (PCRD byte totals)
                        g = float(sum(int(round(v)) for v in vals)) \
                            if all(float(v).is_integer() for v in vals) \
                            else float(sum(vals))
                    elif op == "max":
                        g = max(vals)
                    else:
                        g = min(vals)
                    for h, _, _ in pend:
                        conns[h].send(g)
                    rounds += 1

        # start barrier (see _child_main)
        for h in range(n_hosts):
            assert recv(h)[0] == "ready"
        for h in range(n_hosts):
            conns[h].send("go")
        for _ in range(warmups):
            serve_until("warm")
            for h in range(n_hosts):
                conns[h].send("go")
        t0 = time.perf_counter()
        serve_until("parts")
        compute_wall = time.perf_counter() - t0
        for p in procs:
            p.join(timeout=60)
    finally:
        stop_all()
        for c in conns:
            c.close()

    if _stats is not None:
        _stats["reduce_rounds"] = rounds
        _stats["compute_wall_s"] = compute_wall
        _stats["host_launches"] = launches
    return [pt for h in sorted(results) for pt in results[h]]


def decode_multihost(data: bytes, config=None, n_hosts: int = 2,
                     _stats: Optional[dict] = None, warmups: int = 0,
                     device="cuda") -> np.ndarray:
    """Decode with `n_hosts` separate OS processes, each running the whole
    per-tile chain for its tiles; no reduction crosses hosts (tiles are
    independent), the parent places the pixels.  Pixel-identical to
    models.decoder.decode, quality layers included.  Full-frame,
    full-resolution decodes of raw J2K codestreams whose components are
    not subsampled only (ValueError otherwise, as the JAX package's
    refuses them)."""
    config = config or Config()
    if config.decode_area is not None or config.reduce_resolution:
        raise ValueError("decode_multihost: full-frame decodes only")
    header, _parts, _cs = _parse_for_hosts(data)
    if any(ci.dx != 1 or ci.dy != 1 for ci in header.components):
        raise ValueError("decode_multihost: no subsampling")
    host_device = _prepare(device)
    if n_hosts <= 1:
        parts = _run_inline(
            lambda: host_decode_local(data, config, 0, 1, host_device(0)),
            warmups, _stats)
    else:
        parts = _run_hosts(
            lambda h: ("decode", data, config, h, n_hosts, warmups,
                       host_device(h)),
            n_hosts, warmups, _stats)
    if _stats is not None:
        _stats["cpu_count"] = os.cpu_count()

    n_comps = header.num_components
    out_h = header.height - header.y_offset
    out_w = header.width - header.x_offset
    planes = np.zeros((n_comps, out_h, out_w), _image_dtype(header))
    for t, samples in parts:
        tx0, ty0, tx1, ty1 = header.tile_bounds(t)
        planes[:, ty0 - header.y_offset:ty1 - header.y_offset,
               tx0 - header.x_offset:tx1 - header.x_offset] = samples
    return planes[0] if n_comps == 1 else np.moveaxis(planes, 0, -1)


def _finalize(image, opts, parts: List[Tuple[int, bytes]],
              _stats: Optional[dict]) -> bytes:
    """The codestream gather: tile-parts by tile index, the main header
    before them, EOC after (host 0's job on a real cluster)."""
    header, main = enc.header_and_main(image, opts)
    ordered = [b for _t, b in sorted(parts)]
    if _stats is not None:
        _stats["gathered_bytes"] = sum(len(b) for b in ordered)
        _stats["cpu_count"] = os.cpu_count()
    return enc._finalize_codestream(header, opts, main, ordered, [],
                                    int(image.size))
