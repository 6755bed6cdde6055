"""The port's copies of the block coder (ops/t1, ops/mq) and of the
codestream parser (codestream/parser) under the JAX package's error and
truncation tests: tests/test_truncation.py (exact pass truncation
lengths, every pass of a truncated block decoding to the prefix's
result; the port's MQ coder and block encoder also give the JAX package's
bytes and rates) and tests/test_parser_errors.py (every malformed marker
segment raises ParseError in the port's parser, as in the JAX package's,
and a ValueError through the port's decode; every main-header byte of a
stream forced to 0x00 and 0xFF decodes or raises a ValueError).  Since the
decode options were ported, the port's decode takes every header the
parser admits (signed and 1- to 32-bit samples, subsampling), so the
mutation sweep runs the whole decode on them."""
import struct

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in parallel workers on shared cores

import go_jpeg2000_tpu as jp2k
import go_jpeg2000_tpu_torch as tp
from go_jpeg2000_tpu.codestream.parser import Parser as JaxParser
from go_jpeg2000_tpu.ops import mq as jax_mq
from go_jpeg2000_tpu.ops import t1 as jax_t1
from go_jpeg2000_tpu.options import Format, Options
from go_jpeg2000_tpu_torch.codestream.parser import ParseError, Parser
from go_jpeg2000_tpu_torch.ops import t1
from go_jpeg2000_tpu_torch.ops.mq import MQDecoder, MQEncoder, exact_rates
from go_jpeg2000_tpu_torch.utils import markers as mk


# ------------------------------------------- tests/test_truncation.py

STYLES = [0, mk.CBSTYLE_LAZY, mk.CBSTYLE_RESET,
          mk.CBSTYLE_LAZY | mk.CBSTYLE_RESET | mk.CBSTYLE_VSC]


def _seg_list_for(num_passes, style, seg_lens, rate):
    segs, rem = [], rate
    for _, sl in zip(t1._num_segments(num_passes, style), seg_lens):
        segs.append(min(sl, rem))
        rem = max(0, rem - sl)
    return segs


def test_exact_rates_minimal_vs_bruteforce():
    rng = np.random.RandomState(42)
    n = 1200
    decisions = rng.randint(0, 2, n).tolist()
    ctxs = rng.randint(0, 19, n).tolist()
    enc, ref = MQEncoder(), jax_mq.MQEncoder()
    marks, mark_at, ref_marks = [], [], []
    for i, (d, cx) in enumerate(zip(decisions, ctxs)):
        enc.encode(d, cx)
        ref.encode(d, cx)
        if (i + 1) % 150 == 0 and i + 1 < n:
            marks.append(enc.mark())
            ref_marks.append(ref.mark())
            mark_at.append(i + 1)
    seg = enc.flush()
    assert seg == ref.flush()
    rates = exact_rates(enc.final_buf, len(seg), marks)
    assert rates == jax_mq.exact_rates(ref.final_buf, len(seg), ref_marks)

    def decodes_ok(nd, nbytes):
        dec = MQDecoder(seg[:nbytes])
        return all(dec.decode(ctxs[j]) == decisions[j] for j in range(nd))

    for nd, r in zip(mark_at, rates):
        assert decodes_ok(nd, r), (nd, r)
        if r > 0:
            assert not decodes_ok(nd, r - 1), (nd, r)   # minimal


@pytest.mark.parametrize("style", STYLES)
def test_truncate_every_pass_decodes(style):
    rng = np.random.RandomState(7)
    h, w = 28, 33
    c = rng.randint(-2000, 2000, size=(h, w)).astype(np.int32)
    c[rng.rand(h, w) < 0.6] = 0
    r = t1.encode_block(c, "HL", cb_style=style)
    ref = jax_t1.encode_block(c, "HL", cb_style=style)
    assert r.data == ref.data
    assert [p.rate for p in r.passes] == [p.rate for p in ref.passes]
    assert len(r.passes) > 10
    for i, p in enumerate(r.passes):
        exp = t1.decode_block(
            r.data, w, h, r.num_bitplanes, i + 1, "HL", style,
            _seg_list_for(i + 1, style, r.segment_lengths, len(r.data)))
        got = t1.decode_block(
            r.data[:p.rate], w, h, r.num_bitplanes, i + 1, "HL", style,
            _seg_list_for(i + 1, style, r.segment_lengths, p.rate))
        np.testing.assert_array_equal(exp, got, err_msg=f"pass {i}")
    full = t1.decode_block(r.data, w, h, r.num_bitplanes, len(r.passes),
                           "HL", style, r.segment_lengths)
    np.testing.assert_array_equal(full, c)


def test_rates_monotone_and_tight():
    rng = np.random.RandomState(3)
    c = rng.randint(-500, 500, size=(24, 24)).astype(np.int32)
    c[rng.rand(24, 24) < 0.5] = 0
    rates = [p.rate for p in t1.encode_block(c, "LL").passes]
    assert rates == sorted(rates)
    assert rates[-1] == len(t1.encode_block(c, "LL").data)


# ----------------------------------------- tests/test_parser_errors.py

def seg(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def siz_payload(w=16, h=16, ncomp=1, tw=0, th=0):
    out = struct.pack(">HIIIIIIIIH", 0, w, h, 0, 0, tw or w, th or h, 0, 0,
                      ncomp)
    return out + bytes([7, 1, 1]) * ncomp


def cod_payload(scod=0, prog=0, layers=1, mct=0, decomp=2, cbw=4, cbh=4,
                style=0, transform=1, precincts=b""):
    return (bytes([scod, prog]) + struct.pack(">H", layers)
            + bytes([mct, decomp, cbw, cbh, style, transform]) + precincts)


def qcd_payload(style=0, guard=2, steps=3):
    sqcd = (guard << 5) | style
    if style == 0:
        return bytes([sqcd]) + bytes([(10 << 3)] * steps)
    return bytes([sqcd]) + b"".join(
        struct.pack(">H", (10 << 11) | 100) for _ in range(steps))


SOC = struct.pack(">H", mk.SOC)
EOC = struct.pack(">H", mk.EOC)


def stream(siz=None, cod=None, qcd=None, extra=b""):
    return (SOC + seg(mk.SIZ, siz_payload() if siz is None else siz)
            + seg(mk.COD, cod_payload() if cod is None else cod)
            + seg(mk.QCD, qcd_payload() if qcd is None else qcd)
            + extra + EOC)


def _bad_csiz():
    p = siz_payload()
    return p[:34] + struct.pack(">H", 16385) + p[36:]


def _main_header():
    return stream()[:-2]


MAIN_HEADER_ERRORS = {
    "missing_soc": b"\x00\x00" + stream()[2:],
    "siz_not_after_soc": SOC + seg(mk.COM, b"\x00\x01hi") + stream()[2:],
    "invalid_marker": stream(extra=struct.pack(">HH", 0x1234, 4) + b"\0\0"),
    "length_below_two": stream(extra=struct.pack(">HH", mk.COM, 1)),
    "segment_past_end": stream(extra=struct.pack(">HH", mk.COM, 600)
                               + b"\x00" * 4),
    "siz_zero_components": stream(siz=siz_payload()[:-5]
                                  + struct.pack(">H", 0)),
    "siz_components_over_limit": stream(siz=_bad_csiz()),
    "siz_short_component_data": stream(siz=siz_payload()[:-2]),
    "cod_too_short": stream(cod=cod_payload()[:5]),
    "cod_bad_progression": stream(cod=cod_payload(prog=5)),
    "cod_zero_layers": stream(cod=cod_payload(layers=0)),
    "cod_decompositions_over_32": stream(cod=cod_payload(decomp=33)),
    "cod_block_area_over_4096": stream(cod=cod_payload(cbw=8, cbh=8)),
    "cod_truncated_precincts": stream(cod=cod_payload(
        scod=1, decomp=2, precincts=b"\x55")),
    "coc_component_out_of_range": _main_header()
    + seg(mk.COC, bytes([3, 0]) + cod_payload()[5:]) + EOC,
    "coc_too_short": _main_header() + seg(mk.COC, b"\x00") + EOC,
    "qcc_component_out_of_range": _main_header()
    + seg(mk.QCC, bytes([9]) + qcd_payload()) + EOC,
    "qcc_too_short": _main_header() + seg(mk.QCC, b"") + EOC,
    "qcd_empty": stream(qcd=b""),
    "qcd_invalid_style": stream(qcd=bytes([(2 << 5) | 3]) + b"\x50" * 4),
    "qcd_scalar_odd_length": stream(qcd=bytes([(2 << 5) | 2])
                                    + b"\x12\x34\x56"),
    "qcd_no_step_sizes": stream(qcd=bytes([(2 << 5) | 0])),
    "poc_bad_length": stream(extra=seg(mk.POC, b"\x00" * 6)),
    "cap_too_short": stream(extra=seg(mk.CAP, b"\x00\x00")),
    "tlm_too_short": stream(extra=seg(mk.TLM, b"\x00")),
    "plm_empty": stream(extra=seg(mk.PLM, b"")),
    "plm_nplm_overflow": stream(extra=seg(mk.PLM, b"\x00\x09\x01")),
    "crg_bad_length": stream(extra=seg(mk.CRG, b"\x00\x01\x02")),
}

TILE_PART_ERRORS = {
    "sot_wrong_payload_length": _main_header() + seg(mk.SOT, b"\x00" * 7)
    + EOC,
    "tile_index_out_of_range": _main_header()
    + seg(mk.SOT, struct.pack(">HIBB", 5, 14, 0, 1)) + EOC,
    "bad_marker_in_tile_header": _main_header()
    + seg(mk.SOT, struct.pack(">HIBB", 0, 40, 0, 1))
    + struct.pack(">HH", 0x0bad, 4) + b"\0\0" + EOC,
    "psot_past_end": _main_header()
    + seg(mk.SOT, struct.pack(">HIBB", 0, 10 ** 6, 0, 1))
    + struct.pack(">H", mk.SOD) + b"\x00" * 8,
}


def test_valid_baseline_parses():
    h = Parser(stream()).read_header()
    assert h.width == 16 and h.num_components == 1


@pytest.mark.parametrize("name", sorted(MAIN_HEADER_ERRORS))
def test_main_header_error(name):
    data = MAIN_HEADER_ERRORS[name]
    with pytest.raises(ParseError):
        Parser(data).read_header()
    with pytest.raises(ValueError):       # the JAX parser refuses it too
        JaxParser(data).read_header()
    with pytest.raises(ValueError):
        tp.decode(data, device="cpu")


@pytest.mark.parametrize("name", sorted(TILE_PART_ERRORS))
def test_tile_part_error(name):
    data = TILE_PART_ERRORS[name]
    p = Parser(data)
    h = p.read_header()
    with pytest.raises(ParseError):
        p.read_all_tile_parts(h)
    with pytest.raises(ValueError):
        tp.decode(data, device="cpu")


def test_degenerate_grid_and_expected_sot():
    p = struct.pack(">HIIIIIIIIH", 0, 16, 16, 0, 0, 0, 0, 0, 0, 1) \
        + bytes([7, 1, 1])
    with pytest.raises((ParseError, ValueError, ZeroDivisionError)):
        Parser(stream(siz=p)).read_header()
    h = Parser(stream()).read_header()
    with pytest.raises(ParseError):
        Parser(seg(mk.COM, b"\x00\x01x")).read_tile_part(h)


def test_mutate_every_header_byte():
    """Every main-header byte forced to 0x00 and 0xFF: the port's decode
    either succeeds or raises a ValueError (ParseError, DecodeError), as
    tests/test_parser_errors.py holds the JAX package's."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, size=(32, 32)).astype(np.uint8)
    data = bytearray(jp2k.encode(img, Options(
        format=Format.J2K, lossless=True, num_resolutions=3,
        num_layers=2, compression_ratio=2.0, enable_plt=True,
        enable_tlm=True, comment="mutation-sweep")))
    sod = bytes(data).find(struct.pack(">H", mk.SOD))
    assert sod > 0
    for pos in range(sod + 2):
        orig = data[pos]
        for val in (0x00, 0xFF):
            if val == orig:
                continue
            data[pos] = val
            try:
                tp.decode(bytes(data), device="cpu")
            except ValueError:
                pass
            except (IndexError, KeyError, OverflowError, ZeroDivisionError,
                    struct.error, RuntimeError) as e:
                raise AssertionError(
                    f"uncontrolled {type(e).__name__} at byte {pos}"
                    f"={val:#x}: {e}")
            finally:
                data[pos] = orig
