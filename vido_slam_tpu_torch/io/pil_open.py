"""Which of PIL's plugins ``Image.open`` picks for a file's bytes, without
PIL: ``Image.open``/``_open_core`` (Pillow 12.1) in pure Python.

PIL first tries the plugins ``Image.preinit`` registers (BMP, DIB, GIF,
JPEG, PPM, PNG), then, after ``Image.init``, every other registered plugin
in the order ``Image.ID`` lists them (``PLUGINS``). A plugin takes the
file where its ``_accept`` passes on the first 16 bytes (plugins without
one always try) and its ``_open`` returns with a mode and a size of at
least 1 x 1. Where ``_open`` raises SyntaxError, IndexError, TypeError,
KeyError, EOFError or ``struct.error``, PIL goes on to the next plugin;
any other error leaves ``Image.open``. Where no plugin takes the file,
PIL raises "cannot identify image file" (``UnidentifiedImage``).

Each check here copies the header tests its plugin's ``_open`` makes
before it reads pixels: a plugin the port reads gets every test; one it
does not read (ROADMAP.md queue 1 item 29b) gets its magic and the first
header tests, which is where PIL settles such files in practice (a file
that one of them takes here and whose deeper header fails in PIL raises
in both). Targa has no magic: only ``TgaImagePlugin._open``'s field tests
know it, so every plugin before it in the order matters.
"""

from __future__ import annotations

import math
import re
import struct
from typing import Callable, List, Tuple


class UnidentifiedImage(OSError):
    """PIL's ``UnidentifiedImageError``: no plugin takes the file."""


class PluginFails(OSError):
    """The plugin PIL picks raises in ``Image.open`` or on loading where no
    port of it could do otherwise (EPS without Ghostscript, the stubs
    without a handler)."""


class _Skip(Exception):
    """The plugin's ``_open`` raises an error ``_open_core`` passes over."""


def _u16le(d: bytes, i: int) -> int:
    if i + 2 > len(d):
        raise _Skip("struct.error")
    return d[i] | d[i + 1] << 8


def _u32le(d: bytes, i: int) -> int:
    if i + 4 > len(d):
        raise _Skip("struct.error")
    return struct.unpack_from("<I", d, i)[0]


def _u16be(d: bytes, i: int) -> int:
    if i + 2 > len(d):
        raise _Skip("struct.error")
    return d[i] << 8 | d[i + 1]


def _u32be(d: bytes, i: int) -> int:
    if i + 4 > len(d):
        raise _Skip("struct.error")
    return struct.unpack_from(">I", d, i)[0]


def _byte(d: bytes, i: int) -> int:
    if i >= len(d):
        raise _Skip("IndexError")
    return d[i]


def _sized(w: int, h: int) -> bool:
    """``ImageFile.__init__``'s test after ``_open``."""
    if w <= 0 or h <= 0:
        raise _Skip("not identified by this driver")
    return True


# ---------------------------------------------------------------------------
# the plugins the port reads
# ---------------------------------------------------------------------------

def _dib(d: bytes) -> bool:
    return _u32le(d[:16] + bytes(4), 0) in (12, 40, 52, 56, 64, 108, 124)


def _ppm(d: bytes) -> bool:
    return len(d) >= 2 and d[:1] == b"P" and d[1] in b"0123456fy"


def _pcx(d: bytes) -> bool:
    if not (len(d) >= 2 and d[0] == 10 and d[1] in (0, 2, 3, 5)):
        return False
    s = d[:68]
    x0, y0 = _u16le(s, 4), _u16le(s, 6)
    x1, y1 = _u16le(s, 8) + 1, _u16le(s, 10) + 1
    if x1 <= x0 or y1 <= y0:
        raise _Skip("bad PCX image size")
    bits, planes = s[3], _byte(s, 65)
    _u16le(s, 66)
    if not ((bits == 1 and planes in (1, 2, 4))
            or (s[1] == 5 and bits == 8 and planes in (1, 3))):
        raise PluginFails("unknown PCX mode")
    if bits == 8 and planes == 1 and len(d) < 769:
        # the plugin seeks 769 bytes back from the end for the palette
        raise PluginFails("Invalid argument (a seek before the start)")
    return True


def _ico(d: bytes) -> bool:
    if not d.startswith(b"\x00\x00\x01\x00"):
        return False
    n = _u16le(d, 4)
    if n == 0 or len(d) < 6 + 16 * n:
        raise _Skip("no entry")             # entry[0], or a cut directory
    return True


_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = ("Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type")


def im_header(d: bytes) -> Tuple[dict, int]:
    """``ImImagePlugin``'s header walk: the fields read (every one, as
    strings) and the offset of the byte after the 0x1A that ends the
    header. Raises _Skip where its ``_open`` raises SyntaxError."""
    if b"\n" not in d[:100]:
        raise _Skip("not an IM file")
    info, n, pos = {}, 0, 0
    while True:
        s = d[pos:pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        nl = d.find(b"\n", pos)
        end = len(d) if nl < 0 else nl + 1
        s, pos = s + d[pos:end], end
        if len(s) > 100:
            raise _Skip("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_LINE.match(s)
        if not m:
            raise _Skip("Syntax error in IM header")
        k = m.group(1).decode("latin-1", "replace")
        info[k] = m.group(2).decode("latin-1", "replace")
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise _Skip("Not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = d[pos:pos + 1]
        pos += 1
    if not s:
        raise _Skip("File truncated")
    return info, pos


def im_number(v: str):
    """``ImImagePlugin.number``."""
    try:
        return int(v)
    except ValueError:
        return float(v)


def im_size(info: dict):
    """The ``Image size (x*y)`` field as PIL parses it (512 x 512 without
    one): a tuple, or one number where the field holds one."""
    v = info.get("Image size (x*y)")
    if v is None:
        return (512, 512)
    try:
        t = tuple(map(im_number, v.replace("*", ",").split(",")))
    except ValueError:
        raise PluginFails("IM size field is no number") from None
    return t[0] if len(t) == 1 else t


def _im(d: bytes) -> bool:
    info, pos = im_header(d)
    if "Lut" in info and len(d) - pos < 768:
        raise _Skip("IndexError")           # the palette's bytes
    for key in ("File size (no of images)", "Scale (x,y)"):
        if key in info:
            try:
                [im_number(x) for x in info[key].replace("*", ",")
                 .split(",")]
            except ValueError:
                raise PluginFails(f"IM {key} field is no number") from None
    size = im_size(info)
    if not isinstance(size, tuple):
        raise _Skip("TypeError")            # size[0] of a number
    if len(size) < 2:
        raise _Skip("IndexError")
    w, h = size[0], size[1]
    return _sized(w, h)


def _msp(d: bytes) -> bool:
    if not d.startswith((b"DanM", b"LinS")):
        return False
    s = d[:32]
    if len(s) < 32:
        raise _Skip("struct.error")
    check = 0
    for i in range(0, 32, 2):
        check ^= _u16le(s, i)
    if check:
        raise _Skip("bad MSP checksum")
    return _sized(_u16le(s, 4), _u16le(s, 6))


def _qoi(d: bytes) -> bool:
    if not d.startswith(b"qoif"):
        return False
    w, h = _u32be(d, 4), _u32be(d, 8)
    _byte(d, 12)
    return _sized(w, h)


SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
             (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
             (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def _sgi(d: bytes) -> bool:
    if not (len(d) >= 2 and _u16be(d, 0) == 474):
        return False
    s = d[:512]
    key = (_byte(s, 3), _u16be(s, 4), _u16be(s, 10))
    w, h = _u16be(s, 6), _u16be(s, 8)
    if key not in SGI_MODES:
        raise PluginFails("Unsupported SGI image mode")
    return _sized(w, h)


def tga_header(d: bytes):
    """``TgaImagePlugin._open``'s fields and tests: (id_len, colormaptype,
    imagetype, width, height, depth, flags); raises _Skip where it raises
    SyntaxError."""
    s = d[:18]
    id_len, cmt, kind = _byte(s, 0), _byte(s, 1), _byte(s, 2)
    depth, flags = _byte(s, 16), _byte(s, 17)
    w, h = _u16le(s, 12), _u16le(s, 14)
    if cmt not in (0, 1) or w <= 0 or h <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise _Skip("not a TGA file")
    if kind not in (1, 2, 3, 9, 10, 11):
        raise _Skip("unknown TGA mode")
    if cmt and _byte(s, 7) not in (16, 24, 32):
        raise _Skip("unknown TGA map depth")
    return id_len, cmt, kind, w, h, depth, flags


def _tga(d: bytes) -> bool:
    tga_header(d)
    return True


_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def xbm_header(d: bytes):
    """(width, height, offset of the data) by ``XbmImagePlugin``'s regular
    expression on the first 512 bytes; raises _Skip where it does not
    match."""
    m = _XBM_HEAD.match(d[:512])
    if not m:
        raise _Skip("not a XBM file")
    return int(m.group("width")), int(m.group("height")), m.end()


def _xbm(d: bytes) -> bool:
    if not d[:16].lstrip().startswith(b"#define"):
        return False
    w, h, _ = xbm_header(d)
    return _sized(w, h)


# ---------------------------------------------------------------------------
# the plugins the port does not read (item 29b): magic and first tests
# ---------------------------------------------------------------------------

def _magic(*prefixes: bytes) -> Callable[[bytes], bool]:
    return lambda d: d.startswith(prefixes)


def _avif(d: bytes) -> bool:
    return d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1",
                                             b"msf1")


def _cur(d: bytes) -> bool:
    """``CurImagePlugin``: the largest cursor's bitmap header, read as
    ``BmpImageFile._bitmap`` reads it, at half its height."""
    if not d.startswith(b"\0\0\2\0"):
        return False
    m = b""
    for i in range(_u16le(d, 4)):
        s = d[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif _byte(s, 0) > m[0] and _byte(s, 1) > m[1]:
            m = s
    if not m:
        raise _Skip("No cursors were found")
    pos = _u32le(m, 12)
    size = _u32le(d, pos)
    if size not in (12, 40, 52, 56, 64, 108, 124):
        raise PluginFails("Unsupported BMP header type")
    if len(d) < pos + size:
        raise PluginFails("Truncated File Read")
    if size == 12:
        w, h = _u16le(d, pos + 4), _u16le(d, pos + 6)
    else:
        w, h = _u32le(d, pos + 4), _u32le(d, pos + 8)
        if d[pos + 11] == 0xFF:
            h = 2 ** 32 - h
    return _sized(w, h // 2)


def _dcx(d: bytes) -> bool:
    return len(d) >= 4 and _u32le(d, 0) == 987654321


def _dds(d: bytes) -> bool:
    if not d.startswith(b"DDS "):
        return False
    if len(d) < 8 or _u32le(d, 4) != 124 or len(d) < 128:
        raise PluginFails("DDS header size")
    return True


def _eps(d: bytes) -> bool:
    return d.startswith(b"%!PS") or (len(d) >= 4 and
                                     _u32le(d, 0) == 0xC6D3D0C5)


def _fits(d: bytes) -> bool:
    if not d.startswith(b"SIMPLE"):
        return False
    value = d[8:80].split(b"/")[0].strip()
    if value.startswith(b"="):
        value = value[1:].strip()
    if d[:8].strip() != b"SIMPLE" or value != b"T":
        raise _Skip("Not a FITS file")
    return True


def _fli(d: bytes) -> bool:
    if not (len(d) >= 16 and _u16le(d, 4) in (0xAF11, 0xAF12)
            and _u16le(d, 14) in (0, 3)):
        return False
    s = d[:128]
    if not (s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise _Skip("not an FLI/FLC file")
    return _sized(_u16le(s, 8), _u16le(s, 10))


def _gbr(d: bytes) -> bool:
    if not (len(d) >= 8 and _u32be(d, 0) >= 20 and _u32be(d, 4) in (1, 2)):
        return False
    w, h, depth = _u32be(d, 8), _u32be(d, 12), _u32be(d, 16)
    if w == 0 or h == 0 or depth not in (1, 4):
        raise _Skip("not a GIMP brush")
    if _u32be(d, 4) == 2 and d[20:24] != b"GIMP":
        raise _Skip("not a GIMP brush, bad magic number")
    return True


def _grib(d: bytes) -> bool:
    return len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1


def _imt(d: bytes) -> bool:
    """``ImtImagePlugin``: key lines up to a form feed; it takes the file
    where ``width``, ``height`` and ``pixel n8`` were read."""
    if b"\n" not in d[:100]:
        raise _Skip("not an IM file")
    w = h = 0
    gray = False
    pos = 0
    while pos < len(d):
        if d[pos:pos + 1] == b"\x0c":
            break
        nl = d.find(b"\n", pos)
        line = d[pos:len(d) if nl < 0 else nl]
        pos = len(d) if nl < 0 else nl + 1
        if len(line) <= 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", line)
        if not m:
            break
        k, v = m.groups()
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            raise PluginFails("IMT size is no number") from None
        gray |= k == b"pixel" and v == b"n8"
    if not gray:
        raise _Skip("not identified by this driver")
    return _sized(w, h)


def _iptc(d: bytes) -> bool:
    """``IptcImagePlugin``: its field walk up to the image data, then the
    fields its ``_open`` reads (layers and component, band, size,
    compression)."""
    info, pos = {}, 0
    while True:
        s = d[pos:pos + 5]
        pos += 5
        if not s.strip(b"\x00"):
            break
        if len(s) < 3:
            raise _Skip("IndexError")
        tag = (s[1], s[2])
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise _Skip("invalid IPTC/NAA file")
        size = _byte(s, 3)
        if size > 132:
            raise PluginFails("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes((bytes(4) + d[pos:pos + size - 128])[-4:],
                                  "big")
            pos += s[3] - 128
        else:
            size = _u16be(s, 3)
        if tag == (8, 10):
            break
        data = d[pos:pos + size] if size else None
        pos += size
        info[tag] = [info[tag], data] if tag in info else data

    def field(key):
        v = info.get(key, KeyError)
        if v is KeyError:
            raise _Skip("KeyError")
        if not isinstance(v, bytes):
            raise _Skip("TypeError")        # no data, or a repeated field
        return v

    v = field((3, 60))
    if len(v) < 2:
        raise _Skip("IndexError")
    layers, component = v[0], v[1]
    mode = None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers in (3, 4) and component:
            mode = "RGB" if layers == 3 else "CMYK"
        if (3, 65) in info:
            band = field((3, 65))
            if not band:
                raise _Skip("IndexError")
    w, h = (int.from_bytes((bytes(4) + field(k))[-4:], "big")
            for k in ((3, 20), (3, 30)))
    if (3, 120) not in info:
        raise PluginFails("Unknown IPTC image compression")
    comp = int.from_bytes((bytes(4) + field((3, 120)))[-4:], "big")
    if comp not in (1, 5):
        raise PluginFails("Unknown IPTC image compression")
    if mode is None:
        raise _Skip("not identified by this driver")
    return _sized(w, h)


def _mcidas(d: bytes) -> bool:
    if not d.startswith(b"\0\0\0\0\0\0\0\x04"):
        return False
    if len(d) < 256:
        raise _Skip("not an McIdas area file")
    return True


def _mpeg(d: bytes) -> bool:
    if not d.startswith(b"\x00\x00\x01\xb3"):
        return False
    _byte(d, 6)
    return _sized(d[4] << 4 | d[5] >> 4, (d[5] & 15) << 8 | d[6])


def _pcd(d: bytes) -> bool:
    if not d[2048:].startswith(b"PCD_"):
        raise _Skip("not a PCD file")
    if len(d) < 2048 + 1539:
        raise _Skip("IndexError")
    return True


def _psd(d: bytes) -> bool:
    if not d.startswith(b"8BPS"):
        return False
    if _u16be(d, 4) != 1:
        raise _Skip("not a PSD file")
    return True


def _spider_header(t) -> bool:
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        v = h[i]
        if not math.isfinite(v) or v != int(v):
            return False
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return False
    return int(h[22]) == int(h[13]) * int(h[23]) and int(h[22]) != 0


def _spider(d: bytes) -> bool:
    if len(d) < 92:
        raise _Skip("struct.error")
    for end in (">", "<"):
        if _spider_header(struct.unpack(end + "23f", d[:92])):
            return True
    raise _Skip("not a valid Spider file")


def _webp(d: bytes) -> bool:
    return d.startswith(b"RIFF") and d[8:12] == b"WEBP" and \
        d[12:16] in (b"VP8 ", b"VP8X", b"VP8L")


def _xpm(d: bytes) -> bool:
    return d.startswith(b"/* XPM */")


# (PIL's format name, its check), in the order ``Image.open`` tries them
PLUGINS: List[Tuple[str, Callable[[bytes], bool]]] = [
    ("BMP", _magic(b"BM")), ("DIB", _dib), ("GIF", _magic(b"GIF87a",
                                                          b"GIF89a")),
    ("JPEG", _magic(b"\xff\xd8\xff")), ("PPM", _ppm),
    ("PNG", _magic(b"\x89PNG\r\n\x1a\n")),
    ("AVIF", _avif), ("BLP", _magic(b"BLP1", b"BLP2")),
    ("BUFR", _magic(b"BUFR", b"ZCZC")), ("CUR", _cur), ("PCX", _pcx),
    ("DCX", _dcx), ("DDS", _dds), ("EPS", _eps), ("FITS", _fits),
    ("FLI", _fli), ("FTEX", _magic(b"FTEX")), ("GBR", _gbr),
    ("GRIB", _grib), ("HDF5", _magic(b"\x89HDF\r\n\x1a\n")),
    ("JPEG2000", _magic(b"\xff\x4f\xff\x51",
                        b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
    ("ICNS", _magic(b"icns")), ("ICO", _ico), ("IM", _im), ("IMT", _imt),
    ("IPTC", _iptc), ("MCIDAS", _mcidas),
    ("MPEG", _mpeg),
    ("TIFF", _magic(b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                    b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")),
    ("MSP", _msp), ("PCD", _pcd), ("PIXAR", _magic(b"\200\350\000\000")),
    ("PSD", _psd), ("QOI", _qoi), ("SGI", _sgi), ("SPIDER", _spider),
    ("SUN", lambda d: len(d) >= 4 and _u32be(d, 0) == 0x59A66A95),
    ("TGA", _tga), ("WEBP", _webp),
    ("WMF", _magic(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")),
    ("XBM", _xbm), ("XPM", _xpm), ("XVTHUMB", _magic(b"P7 332")),
]

# the plugins whose reading fails here whatever the file: EPS needs
# Ghostscript, the stubs a handler no one installed
FAILING = {"EPS": "Unable to locate Ghostscript on paths",
           "BUFR": "BUFR image data not available",
           "GRIB": "GRIB image data not available",
           "HDF5": "HDF5 image data not available",
           "WMF": "cannot find loader for this WMF file"}


def pil_format(data: bytes) -> str:
    """The ``format`` of ``Image.open`` on these bytes: the first plugin of
    ``PLUGINS`` that takes them. Raises UnidentifiedImage where none does,
    PluginFails where the plugin PIL picks raises in ``Image.open``."""
    for name, check in PLUGINS:
        try:
            if check(data):
                return name
        except _Skip:
            continue
    raise UnidentifiedImage("cannot identify image file")

