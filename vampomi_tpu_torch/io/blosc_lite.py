# Copied from vampomi_tpu/io/blosc_lite.py (stdlib + numpy; the port imports no JAX).
"""Pure-Python Blosc1 chunk decoder (stdlib + numpy only).

The real `zarr` package's DEFAULT compressor is numcodecs' Blosc
(cname="lz4", byte-shuffle) — so the most likely real-world instance of the
reference's production input format (reference simulation/sim_top_iid.py:
8-16, `zarr.open(...)`) is a directory store whose chunks are Blosc frames.
This module decodes them without any C extension so `io/zarr_lite.py` can
read such stores in zarr-free environments.

Blosc1 chunk layout (c-blosc 1.x, the format numcodecs writes):

    byte 0      format version
    byte 1      codec format version
    byte 2      flags: bit0 byte-shuffle, bit1 memcpyed, bit2 bit-shuffle,
                bits 5-7 compressor code (0 blosclz, 1 lz4/lz4hc, 2 snappy,
                3 zlib, 4 zstd)
    byte 3      typesize
    bytes 4-7   nbytes   (uncompressed size, uint32 LE)
    bytes 8-11  blocksize
    bytes 12-15 cbytes   (total chunk size including this header)

    memcpyed chunks: the remaining nbytes are the raw buffer.
    otherwise: int32 bstarts[nblocks] (absolute offsets into the chunk),
    nblocks = ceil(nbytes / blocksize).  Each block holds one stream — or,
    when byte-shuffle is on and the codec splits (lz4/blosclz do),
    `typesize` streams of neblock/typesize bytes each.  Every stream is
    [int32 csize][payload]; csize == stream size means a verbatim copy.

Byte-shuffle is undone with a numpy reshape/transpose; the LZ4 *block*
format (token, literal run, little-endian match offset, match run with
overlap-capable copies) is decoded in Python — fine for test fixtures and
modest stores; large production stores should install the real zarr stack.
Supported codecs: lz4/lz4hc and zlib; blosclz/snappy/zstd raise clearly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CODEC_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}


def lz4_decompress_block(src: bytes, dst_size: int) -> bytes:
    """Decode one raw LZ4 block (NOT the frame format) of known output size."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n and len(out) < dst_size:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            out += src[i:i + lit]
            i += lit
        if i >= n or len(out) >= dst_size:
            break  # final sequence carries no match
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("corrupt LZ4 block: zero match offset")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: match before window")
        if offset >= mlen:
            out += out[start:start + mlen]
        else:
            # overlapping match: the window repeats with period `offset`
            pattern = out[start:]
            reps = mlen // offset + 1
            out += (bytes(pattern) * reps)[:mlen]
    if len(out) != dst_size:
        raise ValueError(
            f"corrupt LZ4 block: produced {len(out)} of {dst_size} bytes"
        )
    return bytes(out)


def _decode_stream(codec: int, payload: bytes, dst_size: int) -> bytes:
    if codec == 1:  # lz4 / lz4hc share the block format
        return lz4_decompress_block(payload, dst_size)
    if codec == 3:
        out = zlib.decompress(payload)
        if len(out) != dst_size:
            raise ValueError("corrupt zlib stream inside blosc block")
        return out
    name = _CODEC_NAMES.get(codec, f"code {codec}")
    raise ValueError(
        f"blosc codec {name!r} needs the real zarr/numcodecs stack "
        f"(only lz4 and zlib decode without it)"
    )


def _unshuffle(data: bytes, typesize: int) -> bytes:
    arr = np.frombuffer(data, dtype=np.uint8)
    n = arr.size // typesize
    return arr.reshape(typesize, n).T.tobytes()


def _split_streams(
    codec: int, shuffle: bool, typesize: int, neblock: int,
    leftover: bool = False,
) -> int:
    """c-blosc1 splits a block into `typesize` streams for blosclz/lz4 when
    2 <= typesize <= 16 and the per-stream size is >= 128 bytes and the
    block is NOT the leftover (final partial) block — c-blosc's split_block
    is gated on `!leftoverblock` (blosc.c), so a chunk whose nbytes is not
    a multiple of the blocksize compresses its last block as ONE stream
    even when its size happens to divide typesize (round-3 advisor
    finding).  Other codecs compress the block as one stream.  The split is
    independent of the shuffle flag (streams are contiguous segments of the
    possibly-shuffled block either way)."""
    if (
        codec in (0, 1)
        and not leftover
        and 2 <= typesize <= 16
        and neblock % typesize == 0
        and neblock // typesize >= 128
    ):
        return typesize
    return 1


def blosc_decompress(raw: bytes) -> bytes:
    """Decode one Blosc1 chunk to its uncompressed bytes."""
    if len(raw) < 16:
        raise ValueError("blosc chunk shorter than its 16-byte header")
    flags = raw[2]
    typesize = raw[3]
    nbytes, blocksize, cbytes = struct.unpack("<III", raw[4:16])
    if cbytes != len(raw):
        raise ValueError(
            f"blosc chunk length {len(raw)} != header cbytes {cbytes}"
        )
    if flags & 0x2:  # memcpyed: stored verbatim
        out = raw[16:16 + nbytes]
        if len(out) != nbytes:
            raise ValueError("truncated memcpyed blosc chunk")
        return out
    if flags & 0x4:
        raise ValueError("blosc bit-shuffle needs the real zarr/numcodecs stack")
    shuffle = bool(flags & 0x1)
    codec = flags >> 5

    if blocksize == 0 or nbytes == 0:
        return b""
    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = struct.unpack(f"<{nblocks}i", raw[16:16 + 4 * nblocks])

    out = bytearray()
    for j, bs in enumerate(bstarts):
        neblock = min(blocksize, nbytes - j * blocksize)
        nstreams = _split_streams(
            codec, shuffle, typesize, neblock, leftover=neblock < blocksize
        )
        per = neblock // nstreams
        pos = bs
        block = bytearray()
        for _ in range(nstreams):
            (csize,) = struct.unpack("<i", raw[pos:pos + 4])
            pos += 4
            payload = raw[pos:pos + abs(csize)]
            pos += abs(csize)
            if csize == per:  # verbatim stream
                block += payload
            else:
                block += _decode_stream(codec, payload, per)
        if shuffle:
            block = _unshuffle(bytes(block), typesize)
        out += block
    if len(out) != nbytes:
        raise ValueError("blosc chunk decoded to the wrong length")
    return bytes(out)


# --------------------------------------------------------------------------
# fixture-grade compressor: emits REAL blosc/LZ4 chunks (single block,
# shuffle + split exactly like c-blosc writes for lz4) so round-trip tests
# exercise the genuine parse paths without the C library.
# --------------------------------------------------------------------------


def _lz4_compress_naive(src: bytes) -> bytes:
    """Tiny greedy LZ4 block encoder: one literal run, then repeated
    fixed-offset matches when the buffer is periodic, else all literals.
    Produces VALID LZ4 blocks (decodable by any conformant decoder)."""

    def _emit_literals(buf: bytes) -> bytes:
        out = bytearray()
        lit = len(buf)
        token_lit = min(lit, 15)
        out.append(token_lit << 4)
        if token_lit == 15:
            rest = lit - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out += buf
        return bytes(out)

    n = len(src)
    # periodicity probe: smallest period up to 8 bytes.  The LZ4 spec
    # requires the block to END with a literals-only sequence covering the
    # last 5 bytes, so the match stops short of a literal tail.
    tail = 5
    for period in range(1, 9):
        if n > period + 4 + tail + 4 and src[period:] == src[:-period]:
            head = src[: period + 4]  # literals covering period + match seed
            mlen = n - len(head) - tail
            if mlen < 4:
                break
            out = bytearray()
            lit = len(head)
            ml_token = min(mlen - 4, 15)
            out.append((min(lit, 15) << 4) | ml_token)
            if lit >= 15:
                rest = lit - 15
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)
            out += head
            out += struct.pack("<H", period)
            if ml_token == 15:
                rest = mlen - 4 - 15
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)
            out += _emit_literals(src[n - tail:])
            return bytes(out)
    return _emit_literals(src)


def blosc_compress_lz4(
    data: bytes, typesize: int, shuffle: bool = True, blocksize: int = 0,
) -> bytes:
    """Build one Blosc1 chunk (codec lz4) from `data`.  Default: a single
    block spanning the chunk.  An explicit `blocksize` (multiple of
    typesize, like c-blosc picks) produces a multi-block chunk whose FINAL
    block may be partial — c-blosc compresses that leftover block as one
    unsplit stream (see _split_streams), and this writer mirrors it so the
    decoder's leftover path has a genuine fixture."""
    nbytes = len(data)
    if shuffle and typesize > 1 and nbytes % typesize == 0:
        shuffle = True
    else:
        shuffle = False
    if blocksize <= 0:
        blocksize = max(nbytes, 1)
    if shuffle and blocksize % typesize != 0:
        raise ValueError("blocksize must be a multiple of typesize")
    codec = 1
    nblocks = max((nbytes + blocksize - 1) // blocksize, 1)

    bstarts = []
    body = bytearray()
    body_base = 16 + 4 * nblocks
    for j in range(nblocks):
        raw_block = data[j * blocksize:(j + 1) * blocksize]
        neblock = len(raw_block)
        if shuffle and neblock % typesize == 0 and neblock:
            arr = np.frombuffer(raw_block, dtype=np.uint8)
            shuf = arr.reshape(-1, typesize).T.tobytes()
        else:
            shuf = raw_block
        nstreams = _split_streams(
            codec, shuffle, typesize, neblock,
            leftover=neblock < blocksize,
        ) if neblock else 1
        per = neblock // nstreams if nstreams else 0
        bstarts.append(body_base + len(body))
        for s in range(nstreams):
            stream = shuf[s * per:(s + 1) * per]
            comp = _lz4_compress_naive(stream)
            if len(comp) >= per:  # store verbatim, exactly like c-blosc
                body += struct.pack("<i", per) + stream
            else:
                body += struct.pack("<i", len(comp)) + comp

    header = bytearray(16)
    header[0] = 2
    header[1] = 1
    header[2] = (codec << 5) | (0x1 if shuffle else 0)
    header[3] = typesize
    struct.pack_into("<III", header, 4, nbytes, blocksize,
                     body_base + len(body))
    return (bytes(header)
            + struct.pack(f"<{nblocks}i", *bstarts)
            + bytes(body))
