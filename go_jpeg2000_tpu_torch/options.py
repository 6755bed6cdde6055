"""Public option / config / metadata types (copied from the JAX package).

API-surface parity with the reference's public types
(go-jpeg2000 jpeg2000.go:30-393): Format, Profile, ProgressionOrder,
ColorSpace, Config, Options, Metadata — re-expressed as Python enums and
dataclasses (the Go `image` integration is replaced by a NumPy-array API).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple


class Format(enum.IntEnum):
    """JPEG 2000 file format."""
    J2K = 0   # raw codestream
    JP2 = 1   # JP2 container (boxes)
    JPX = 2   # extended JP2 (Part 2)

    def __str__(self) -> str:
        return self.name


class Profile(enum.IntEnum):
    """JPEG 2000 profile (Rsiz parameter in SIZ)."""
    NONE = 0x0000
    PART2 = 0x8000
    CINEMA_2K = 0x0003
    CINEMA_4K = 0x0004
    CINEMA_S2K = 0x0005
    CINEMA_S4K = 0x0006
    CINEMA_SLTE = 0x0007
    BROADCAST_SINGLE = 0x0100
    BROADCAST_MULTI = 0x0200
    IMF_2K = 0x0400
    IMF_4K = 0x0500
    IMF_8K = 0x0600


class ProgressionOrder(enum.IntEnum):
    """Packet progression order (Table A.16)."""
    LRCP = 0  # Layer-Resolution-Component-Position
    RLCP = 1  # Resolution-Layer-Component-Position
    RPCL = 2  # Resolution-Position-Component-Layer
    PCRL = 3  # Position-Component-Resolution-Layer
    CPRL = 4  # Component-Position-Resolution-Layer

    def __str__(self) -> str:
        return self.name


class ColorSpace(enum.IntEnum):
    """Color space; values 0-5 match the OpenJPEG OPJ_COLOR_SPACE enum
    (reference parity: jpeg2000.go:121-198)."""
    UNKNOWN = -1
    UNSPECIFIED = 0
    SRGB = 1          # enumcs 16
    GRAY = 2          # enumcs 17
    SYCC = 3          # enumcs 18 (and 1)
    EYCC = 4          # enumcs 24
    CMYK = 5          # enumcs 12
    BILEVEL = 6       # enumcs 0, 15
    YCBCR2 = 7        # enumcs 3 (BT.601 625-line)
    YCBCR3 = 8        # enumcs 4 (BT.601 525-line)
    PHOTO_YCC = 9     # enumcs 9
    CMY = 10          # enumcs 11
    YCCK = 11         # enumcs 13
    CIELAB = 12       # enumcs 14
    CIEJAB = 13       # enumcs 19
    ESRGB = 14        # enumcs 20
    ROMM_RGB = 15     # enumcs 21
    YPBPR60 = 16      # enumcs 22
    YPBPR50 = 17      # enumcs 23


# enumcs (JP2 colr box enumerated colourspace) <-> ColorSpace mapping
ENUMCS_TO_COLORSPACE = {
    0: ColorSpace.BILEVEL,
    1: ColorSpace.SYCC,
    3: ColorSpace.YCBCR2,
    4: ColorSpace.YCBCR3,
    9: ColorSpace.PHOTO_YCC,
    11: ColorSpace.CMY,
    12: ColorSpace.CMYK,
    13: ColorSpace.YCCK,
    14: ColorSpace.CIELAB,
    15: ColorSpace.BILEVEL,
    16: ColorSpace.SRGB,
    17: ColorSpace.GRAY,
    18: ColorSpace.SYCC,
    19: ColorSpace.CIEJAB,
    20: ColorSpace.ESRGB,
    21: ColorSpace.ROMM_RGB,
    22: ColorSpace.YPBPR60,
    23: ColorSpace.YPBPR50,
    24: ColorSpace.EYCC,
}

COLORSPACE_TO_ENUMCS = {
    ColorSpace.BILEVEL: 0,
    ColorSpace.SYCC: 18,
    ColorSpace.YCBCR2: 3,
    ColorSpace.YCBCR3: 4,
    ColorSpace.PHOTO_YCC: 9,
    ColorSpace.CMY: 11,
    ColorSpace.CMYK: 12,
    ColorSpace.YCCK: 13,
    ColorSpace.CIELAB: 14,
    ColorSpace.SRGB: 16,
    ColorSpace.GRAY: 17,
    ColorSpace.CIEJAB: 19,
    ColorSpace.ESRGB: 20,
    ColorSpace.ROMM_RGB: 21,
    ColorSpace.YPBPR60: 22,
    ColorSpace.YPBPR50: 23,
    ColorSpace.EYCC: 24,
}


@dataclasses.dataclass
class Config:
    """Decoding configuration (reference parity: jpeg2000.go:200-212).

    Unlike the reference — which accepts but ignores DecodeArea and
    QualityLayers (decoder.go:289-295) — all three fields are honored here.
    """
    # (x0, y0, x1, y1) region to decode, in full-resolution image coords.
    decode_area: Optional[Tuple[int, int, int, int]] = None
    # Number of highest resolution levels to skip (0 = full resolution).
    reduce_resolution: int = 0
    # Number of quality layers to decode (0 = all).
    quality_layers: int = 0
    # Allocation guard: refuse to decode images above this many pixels
    # per component plane (malformed SIZ dimensions would otherwise drive
    # multi-terabyte allocations — found by the r4 header-mutation sweep).
    max_pixels: int = 1 << 32


@dataclasses.dataclass
class Options:
    """Encoding options (reference parity: jpeg2000.go:214-302)."""
    format: Format = Format.JP2
    profile: Profile = Profile.NONE
    lossless: bool = False
    quality: int = 75                    # 1-100, lossy only
    compression_ratio: float = 0.0       # target ratio when quality == 0
    num_resolutions: int = 6             # decomposition levels + 1
    code_block_size: Tuple[int, int] = (6, 6)   # log2 (width, height)
    precinct_size: Optional[Sequence[Tuple[int, int]]] = None  # log2 per res
    progression_order: ProgressionOrder = ProgressionOrder.LRCP
    num_layers: int = 1
    tile_size: Tuple[int, int] = (0, 0)  # (0,0) => whole image is one tile
    tile_offset: Tuple[int, int] = (0, 0)
    image_offset: Tuple[int, int] = (0, 0)
    color_space: ColorSpace = ColorSpace.UNSPECIFIED
    icc_profile: Optional[bytes] = None
    comment: str = ""
    enable_sop: bool = False
    enable_eph: bool = False
    enable_ppt: bool = False             # pack packet headers into PPT markers
    enable_ppm: bool = False             # pack packet headers into main-header PPM
    enable_plt: bool = False             # PLT packet-length marker per tile-part
    enable_tlm: bool = False             # TLM tile-part-length marker in main header
    precision: int = 0                   # 0 = natural precision of input
    # Multiple component transform: None = auto (RCT if lossless else ICT
    # when >= 3 components), True/False to force.
    mct: Optional[bool] = None
    # HTJ2K (Part 15)
    high_throughput: bool = False
    ht_block_width: int = 0              # 0 => use code_block_size
    ht_block_height: int = 0
    # 3-pass HT sets (cleanup + SigProp + MagRef): gives PCRD/quality layers
    # three truncation points per block.  In lossless mode blocks whose
    # refined set would drop unreachable odd units automatically fall back
    # to a cleanup-only set, preserving bit-exactness.
    # None (default) = auto: ON whenever the truncation points are consumed
    # (num_layers > 1 or a compression_ratio budget), OFF on the plain
    # single-layer throughput path (cleanup-only keeps the fused device
    # kernel engaged).  True/False force it.
    ht_refinement: Optional[bool] = None
    # Spec-exact D.4.1 minimal truncation lengths for PCRD pass boundaries.
    # Off (default): monotone upper-bound lengths — always-valid truncation
    # points that cost <= 0.01 dB at matched rates but encode 2-50x faster
    # (measured r4).  On: the exact-rate scan (tests/test_truncation.py).
    exact_rates: bool = False
    # Code-block style flags (bypass/reset/termall/vsc/pterm/segsym)
    code_block_style: int = 0
    # Progression order changes (POC): list of
    # (res_start, comp_start, layer_end, res_end, comp_end, order) tuples.
    progression_changes: Optional[Sequence[Tuple[int, int, int, int, int, int]]] = None
    # Entropy backend, same field as the JAX package's Options.  HTJ2K:
    # "auto" and "native" (the fused device HT encode where it applies,
    # else the native C++ HT coder; "device" and "hybrid" the native
    # coder, as in the JAX package).  Part-1 EBCOT batches: "device" and
    # "auto" (path A: decisions, MQ coder and segment pool on the device),
    # "hybrid" (path B: decisions on the device, the native MQ coder on the
    # host) and "native" (path C: the native C++ EBCOT coder on the host);
    # `encode` codes every block natively.  "python" codes every block with
    # the Python coders (ops/ht.py, ops/t1.py), the transforms still on the
    # device, as in the JAX package.
    backend: str = "auto"


def default_options() -> Options:
    """Reference parity: DefaultOptions (jpeg2000.go:305-316)."""
    return Options()


@dataclasses.dataclass
class ComponentMetadata:
    precision: int
    signed: bool
    subsampling_x: int
    subsampling_y: int


@dataclasses.dataclass
class Metadata:
    """Header-only decode result (reference parity: jpeg2000.go:344-393)."""
    format: Format
    width: int
    height: int
    num_components: int
    components: Sequence[ComponentMetadata]
    color_space: ColorSpace
    tile_width: int
    tile_height: int
    num_tiles_x: int
    num_tiles_y: int
    num_resolutions: int
    num_layers: int
    progression_order: ProgressionOrder
    lossless: bool
    is_htj2k: bool
    code_block_width: int
    code_block_height: int
    profile: int
    comments: Sequence[str]
    icc_profile: Optional[bytes] = None


_ENUM_FIELDS = {"format": Format, "profile": Profile,
                "progression_order": ProgressionOrder,
                "color_space": ColorSpace}


def _from_reference(cls, obj):
    """Build `cls` from any object carrying the same field names; enum
    fields are mapped through their integer values."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if f.name in _ENUM_FIELDS:
            v = _ENUM_FIELDS[f.name](int(v))
        kw[f.name] = v
    return cls(**kw)


def options_from_reference(o) -> Options:
    """The port's Options from the JAX package's Options (or any object with
    its field names and enum values)."""
    return _from_reference(Options, o)


def config_from_reference(c) -> Config:
    """The port's Config from the JAX package's Config."""
    return _from_reference(Config, c)
