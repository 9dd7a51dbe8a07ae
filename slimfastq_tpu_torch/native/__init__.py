"""ctypes bindings for the native host library (host.cpp).

Builds _host.so on first import (g++ -O3) and caches it next to the source.
The library is required: a failed build or load raises (the port has no
pure-Python host pipeline to fall back to).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..models.matcher import sample_mask

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host.cpp")
_SO = os.path.join(_DIR, "_host.so")

lib = None


def _build() -> None:
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return
    tmp = f"{_SO}.{os.getpid()}.tmp"  # concurrent builds never share it
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", "-fopenmp", _SRC, "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:  # retry without OpenMP (optional dep)
        r = subprocess.run([c for c in cmd if c != "-fopenmp"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {_SO} failed:\n{r.stderr}")
    os.replace(tmp, _SO)


def _load():
    global lib
    _build()
    # Bounded OpenMP barrier spin (must be set before libgomp
    # initialises). The pipelined encode/decode runs OpenMP regions from
    # several Python threads — one libgomp team per calling thread — and
    # the default long spin makes an idle team steal cores from the
    # active one (measured: decode-finish wall time was bimodal 8 vs
    # 60-80 ms per 64k block inside the 3-stage pipeline; a 20k spin
    # stabilises it without the sleep/wake latency OMP_WAIT_POLICY=
    # passive adds to the short hot regions).
    os.environ.setdefault("GOMP_SPINCOUNT", "20000")
    lib = ctypes.CDLL(_SO)
    i64 = ctypes.c_int64
    p8 = ctypes.POINTER(ctypes.c_uint8)
    pi64 = ctypes.POINTER(i64)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pp8 = ctypes.POINTER(ctypes.c_void_p)

    lib.crc32_buf.restype = ctypes.c_uint32
    lib.crc32_buf.argtypes = [p8, i64]
    lib.set_omp_threads.restype = None
    lib.set_omp_threads.argtypes = [i64]
    lib.get_omp_threads.restype = i64
    lib.get_omp_threads.argtypes = []
    lib.fastq_index.restype = i64
    lib.fastq_index.argtypes = [p8, i64, i64] + [pi64] * 9
    lib.lens_encode.restype = i64
    lib.lens_encode.argtypes = [pi64, i64, i64, i64, p8, i64, pi64]
    lib.ragged_pack_rows.restype = i64
    lib.ragged_pack_rows.argtypes = [p8, i64, i64, pi64, p8]
    lib.ragged_unpack_rows.restype = None
    lib.ragged_unpack_rows.argtypes = [p8, i64, i64, pi64, p8]
    lib.lens_decode.restype = i64
    lib.lens_decode.argtypes = [pp8, pi64, i64, i64, i64, pi64]
    lib.ids_encode.restype = i64
    lib.ids_encode.argtypes = [p8, pi64, pi64, pi64, pi64, i64, i64, i64,
                               p8, p8, i64, pi64, p8, i64, pi64]
    lib.ids_decode.restype = i64
    lib.ids_decode.argtypes = [i64, i64, i64, p8, pp8, pi64, pp8, pi64,
                               p8, i64, pi64, pi64, p8, i64, pi64, pi64,
                               pi64]
    lib.flags_reorder.restype = None
    lib.flags_reorder.argtypes = [p8, i64, i64, p8]
    lib.fastq_assemble.restype = i64
    lib.fastq_assemble.argtypes = [i64, p8, pi64, pi64, p8, pi64, p8,
                                   pi64, p8, pi64, pi64, p8, i64]
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    lib.pack_lanes.restype = i64
    lib.pack_lanes.argtypes = [p8, pi64, pi64, i64, i64, i64, p8,
                               ctypes.c_int32, pu32, pi64]
    lib.pack_lanes2.restype = i64
    lib.pack_lanes2.argtypes = [p8, pi64, pi64, i64, i64, i64, p8,
                                ctypes.c_int32, pu32, pi64, pi32]
    lib.transpose_u32.restype = None
    lib.transpose_u32.argtypes = [pu32, pu32, i64, i64]
    lib.unpack_lanes.restype = i64
    lib.unpack_lanes.argtypes = [pu32, pi64, i64, i64, i64, p8,
                                 ctypes.c_int32, p8, pi64]
    lib.pack_lanes2_u8.restype = i64
    lib.pack_lanes2_u8.argtypes = [p8, pi64, pi64, i64, i64, i64, p8,
                                   ctypes.c_int32, p8, pi64, pi32]
    lib.transpose_u8.restype = None
    lib.transpose_u8.argtypes = [p8, p8, i64, i64]
    lib.unpack_lanes2_u8.restype = i64
    lib.unpack_lanes2_u8.argtypes = [p8, pi64, i64, i64, i64, p8,
                                     ctypes.c_int32, p8, pi64]
    lib.minmax_ranges.restype = None
    lib.minmax_ranges.argtypes = [p8, pi64, pi64, i64, pi64, pi64]
    lib.scan_bad.restype = i64
    lib.scan_bad.argtypes = [p8, pi64, pi64, i64, pi32]
    lib.compact_lanes.restype = i64
    lib.compact_lanes.argtypes = [p8, pi32, pu32, pi64, i64, i64, i64, i64,
                                  p8, i64, pi64]
    lib.flush_append.restype = None
    lib.flush_append.argtypes = [p8, i64, i64, pi64, pu32, pi64, p8, i64]
    lib.seqx_encode.restype = i64
    lib.seqx_encode.argtypes = [p8, pi64, pi64, i64, i64, p8, i64, pi64,
                                pi32]
    lib.seqx_apply.restype = i64
    lib.seqx_apply.argtypes = [pp8, pi64, i64, i64, i64, pi64, pi64, p8]
    lib.match_find.restype = i64
    lib.match_find.argtypes = [p8, pi64, pi64, i64, i64, i64, pi64, p8,
                               pi64, pi64]
    lib.match_apply.restype = None
    lib.match_apply.argtypes = [p8, p8, pi64, pi64, i64, pi64, p8,
                                pi64, pi64, i64]
    lib.match_parse.restype = i64
    lib.match_parse.argtypes = [pp8, pi64, i64, i64, pi64, pi64, p8,
                                pi64]
    lib.match_reconstruct_arrays.restype = None
    lib.match_reconstruct_arrays.argtypes = [p8, pi64, pi64, pi64,
                                             pi64, p8, pi64, i64]
    lib.match_encode_lanes.restype = i64
    lib.match_encode_lanes.argtypes = [pi64, p8, pi64, pi64, i64,
                                       i64, i64, p8, i64, pi64]
    lib.match_mflag.restype = None
    lib.match_mflag.argtypes = [pi64, pi64, pi64, i64, pi64, i64,
                                i64, i64, p8]


_load()


def _p8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _pi64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pi32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _bufptrs(bufs: list[np.ndarray]):
    arr = (ctypes.c_void_p * len(bufs))()
    for i, b in enumerate(bufs):
        arr[i] = b.ctypes.data if b.size else None
    return ctypes.cast(arr, ctypes.POINTER(ctypes.c_void_p)), arr


def available() -> bool:
    return lib is not None


class pipeline_omp_cap:
    """Context manager: cap the OpenMP team size of the CALLING thread
    while the 3-stage block pipeline runs (teams of cores/2 cut the
    decode wall and its variance). An OpenMP thread count is per calling
    thread (measured: tests/test_torch_tools.py), so the cap reaches only
    the regions this thread starts; the prep pool's threads keep full
    teams. Restores the previous width on exit so isolated stage calls
    keep full teams. SFQ_PIPE_OMP_THREADS overrides the cap (0 = leave
    unchanged), as in the JAX package."""

    def __enter__(self):
        env = os.environ.get("SFQ_PIPE_OMP_THREADS")
        cap = int(env) if env else max(1, (os.cpu_count() or 4) // 2)
        self._prev = None
        if cap > 0:
            self._prev = int(lib.get_omp_threads())
            lib.set_omp_threads(cap)
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            lib.set_omp_threads(self._prev)
        return False


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def fastq_index(data):
    """Returns dict of per-record offset/length arrays, or raises ValueError."""
    buf = _as_u8(data)
    cap = max(len(data) // 8, 4)
    outs = {k: np.zeros(cap, dtype=np.int64)
            for k in ("id_off", "id_len", "seq_off", "seq_len", "plus_off",
                      "plus_len", "qual_off", "qual_len")}
    err = np.zeros(1, dtype=np.int64)
    n = lib.fastq_index(_p8(buf), len(buf), cap,
                        _pi64(outs["id_off"]), _pi64(outs["id_len"]),
                        _pi64(outs["seq_off"]), _pi64(outs["seq_len"]),
                        _pi64(outs["plus_off"]), _pi64(outs["plus_len"]),
                        _pi64(outs["qual_off"]), _pi64(outs["qual_len"]),
                        _pi64(err))
    if n < 0:
        raise ValueError(f"malformed FASTQ near record {int(err[0])}")
    return {k: v[:n] for k, v in outs.items()}, int(n)


def lens_encode(lengths: np.ndarray, wa: int,
                prev_step: int = 1) -> list[np.ndarray]:
    """Per-lane LEN streams (svarint deltas, lane = r % wa)."""
    n = len(lengths)
    stride = 10 * ((n + max(wa, 1) - 1) // max(wa, 1)) + 16
    arena = np.empty(wa * stride, dtype=np.uint8)
    sizes = np.zeros(wa, dtype=np.int64)
    r = lib.lens_encode(_pi64(np.ascontiguousarray(lengths)), n, wa,
                        prev_step, _p8(arena), stride, _pi64(sizes))
    if r < 0:
        raise RuntimeError("lens_encode overflow")
    return [arena[w * stride: w * stride + sizes[w]].copy()
            for w in range(wa)]


def crc32(data) -> int:
    """zlib-compatible CRC32 (chunk-parallel slice-by-8; equality with
    zlib.crc32 is pinned by tests). Accepts bytes or a uint8 array."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else \
        np.ascontiguousarray(data, dtype=np.uint8)
    return int(lib.crc32_buf(_p8(buf), buf.size))


def ragged_pack_rows(payload: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """[W, maxlen] u8 + per-row lens -> concatenated unpadded bytes."""
    W, maxlen = payload.shape
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = np.empty(int(lens.sum()), dtype=np.uint8)
    lib.ragged_pack_rows(_p8(np.ascontiguousarray(payload)), W, maxlen,
                         _pi64(lens), _p8(out))
    return out


def flush_append(pay: np.ndarray, totals: np.ndarray, low: np.ndarray,
                 counts: np.ndarray, maxlen: int) -> np.ndarray:
    """Compacted payload [W, paylen] (its rows may sit at a wider pitch)
    + per-lane totals -> padded payload [W, maxlen] with 4 flush bytes
    appended per active lane (the coder tail after device compaction,
    ops/streams_torch)."""
    W, paylen = pay.shape
    if pay.strides[1] != 1 or pay.strides[0] < paylen:
        pay = np.ascontiguousarray(pay)
    pitch = pay.strides[0] if W > 1 else paylen
    out = np.empty((W, max(maxlen, 1)), dtype=np.uint8)
    lib.flush_append(_p8(pay), W, pitch,
                     _pi64(np.ascontiguousarray(totals, dtype=np.int64)),
                     _pu32(np.ascontiguousarray(low, dtype=np.uint32)),
                     _pi64(np.ascontiguousarray(counts, dtype=np.int64)),
                     _p8(out), maxlen)
    return out[:, :maxlen]


def ragged_unpack_rows(flat: np.ndarray, lens: np.ndarray,
                       maxlen: int) -> np.ndarray:
    """Inverse of ragged_pack_rows: flat bytes -> zero-padded [W, maxlen]."""
    W = len(lens)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    mat = np.zeros((W, maxlen), dtype=np.uint8)
    lib.ragged_unpack_rows(_p8(np.ascontiguousarray(flat)), W, maxlen,
                           _pi64(lens), _p8(mat))
    return mat


def lens_decode(lane_bufs: list[np.ndarray], n: int, wa: int,
                prev_step: int = 1) -> np.ndarray:
    lengths = np.zeros(max(n, 1), dtype=np.int64)
    ptrs, keep = _bufptrs(lane_bufs)
    sizes = np.array([len(b) for b in lane_bufs], dtype=np.int64)
    r = lib.lens_decode(ptrs, _pi64(sizes), n, wa, prev_step,
                        _pi64(lengths))
    if r < 0:
        raise ValueError("corrupt LEN stream")
    return lengths[:n]


def ids_encode(data, idx: dict, n: int, wa: int, prev_step: int = 1):
    buf = _as_u8(data)
    flags = np.zeros(3 * max(n, 1), dtype=np.uint8)
    total_id = int(idx["id_len"].sum()) if n else 0
    total_plus = int(idx["plus_len"].sum()) if n else 0
    rec_per_lane = (n + wa - 1) // max(wa, 1) + 1
    # round-robin keeps lanes balanced; 4x margin, retry with the full
    # worst case on overflow
    dstride = 16 * rec_per_lane + 64
    xstride = 4 * (total_id + total_plus) // max(wa, 1) + 16 * rec_per_lane \
        + 64
    for attempt in range(2):
        # np.empty: C++ writes sizes[w] bytes per row and only those are
        # sliced out below (zeroing 8MB arenas measured ~3ms/block)
        delta = np.empty(wa * dstride, dtype=np.uint8)
        exc = np.empty(wa * xstride, dtype=np.uint8)
        dsizes = np.zeros(wa, dtype=np.int64)
        xsizes = np.zeros(wa, dtype=np.int64)
        r = lib.ids_encode(_p8(buf), _pi64(idx["id_off"]),
                           _pi64(idx["id_len"]),
                           _pi64(idx["plus_off"]), _pi64(idx["plus_len"]),
                           n, wa, prev_step, _p8(flags),
                           _p8(delta), dstride, _pi64(dsizes),
                           _p8(exc), xstride, _pi64(xsizes))
        if r >= 0:
            break
        dstride = 32 * rec_per_lane + 64
        xstride = total_id + total_plus + 16 * rec_per_lane + 64
    if r < 0:
        raise RuntimeError("ids_encode overflow")
    dl = [delta[w * dstride: w * dstride + dsizes[w]].copy()
          for w in range(wa)]
    xl = [exc[w * xstride: w * xstride + xsizes[w]].copy()
          for w in range(wa)]
    return flags[: 3 * n], dl, xl


def ids_decode(n: int, wa: int, flags: np.ndarray,
               delta_bufs: list[np.ndarray], exc_bufs: list[np.ndarray],
               prev_step: int = 1):
    total_exc = sum(len(b) for b in exc_bufs)
    dptrs, k1 = _bufptrs(delta_bufs)
    xptrs, k2 = _bufptrs(exc_bufs)
    dsz = np.array([len(b) for b in delta_bufs], dtype=np.int64)
    xsz = np.array([len(b) for b in exc_bufs], dtype=np.int64)
    # -2 = arena overflow (legitimate input with long delta-coded IDs can
    # exceed the 64 B/record heuristic): retry with a bigger arena
    for scale in (1, 8, 64):
        arena_cap = total_exc + scale * 64 * n + (1024 + wa * 64) * scale
        plus_cap = total_exc + scale * (64 + 2) * n + (1024 + wa * 64) \
            * scale
        # np.empty: only [off, off+len) ranges are ever read back, and
        # zeroing ~9 MB of arena measured ~2-3 ms/block
        id_arena = np.empty(arena_cap, dtype=np.uint8)
        plus_arena = np.empty(plus_cap, dtype=np.uint8)
        out_off = np.empty(max(n, 1), dtype=np.int64)
        out_len = np.empty(max(n, 1), dtype=np.int64)
        p_off = np.empty(max(n, 1), dtype=np.int64)
        p_len = np.empty(max(n, 1), dtype=np.int64)
        plus_used = np.zeros(1, dtype=np.int64)
        r = lib.ids_decode(n, wa, prev_step,
                           _p8(np.ascontiguousarray(flags)),
                           dptrs, _pi64(dsz), xptrs, _pi64(xsz),
                           _p8(id_arena), arena_cap, _pi64(out_off),
                           _pi64(out_len), _p8(plus_arena), plus_cap,
                           _pi64(p_off), _pi64(p_len), _pi64(plus_used))
        if r != -2:
            break
    if r < 0:
        raise ValueError("corrupt ID streams")
    return (id_arena, out_off[:n], out_len[:n],
            plus_arena, p_off[:n], p_len[:n])


def _pu32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def pack_lanes(src: np.ndarray, offs: np.ndarray, lens: np.ndarray,
               W: int, S: int, map256: np.ndarray | None = None,
               bias: int = 0, dtype=np.uint32):
    """Returns (mat [S, W] `dtype`, lane_totals [W], n_bad, rec_bad [n]).

    OpenMP record-parallel fill + blocked C++ transpose (the NumPy
    `ascontiguousarray(matT.T)` copy measured ~13 ms per 26 MB matrix).
    dtype=np.uint8 halves twice the memory traffic (all stream symbols
    fit in a byte); the device kernels upcast once on entry."""
    n = len(offs)
    u8 = np.dtype(dtype) == np.uint8
    matT = np.zeros((W, max(S, 1)), dtype=dtype)
    totals = np.zeros(W, dtype=np.int64)
    rec_bad = np.zeros(max(n, 1), dtype=np.int32)
    mp = _p8(map256) if map256 is not None else \
        ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    fill = lib.pack_lanes2_u8 if u8 else lib.pack_lanes2
    bad = fill(_p8(src), _pi64(np.ascontiguousarray(offs)),
               _pi64(np.ascontiguousarray(lens)), n, W,
               max(S, 1), mp, bias,
               _p8(matT) if u8 else _pu32(matT), _pi64(totals),
               _pi32(rec_bad))
    mat = np.empty((max(S, 1), W), dtype=dtype)
    if u8:
        lib.transpose_u8(_p8(matT), _p8(mat), W, max(S, 1))
    else:
        lib.transpose_u32(_pu32(matT), _pu32(mat), W, max(S, 1))
    return mat[:S], totals, int(bad), rec_bad[:n]


def transpose_mat(mat: np.ndarray) -> np.ndarray:
    """[A, B] uint32/uint8 -> contiguous [B, A] via the blocked C++
    transpose (NumPy ascontiguousarray(mat.T) measured ~13 ms per 26 MB
    matrix)."""
    A, B = mat.shape
    if mat.dtype == np.uint8:
        out = np.empty((B, A), dtype=np.uint8)
        lib.transpose_u8(_p8(np.ascontiguousarray(mat)), _p8(out), A, B)
        return out
    out = np.empty((B, A), dtype=np.uint32)
    lib.transpose_u32(_pu32(np.ascontiguousarray(mat, dtype=np.uint32)),
                      _pu32(out), A, B)
    return out


def unpack_lanes(mat: np.ndarray, lens: np.ndarray, W: int,
                 out_offs: np.ndarray, total: int,
                 map256: np.ndarray | None = None,
                 bias: int = 0) -> np.ndarray:
    """mat: [S, W] uint32/uint8 -> record-major byte buffer."""
    S = mat.shape[0]
    out = np.zeros(max(total, 1), dtype=np.uint8)
    mp = _p8(map256) if map256 is not None else \
        ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    if mat.dtype == np.uint8:
        matT = transpose_mat(mat) if mat.size else \
            np.zeros((W, max(S, 1)), dtype=np.uint8)
        lib.unpack_lanes2_u8(_p8(matT), _pi64(np.ascontiguousarray(lens)),
                             len(lens), W, max(S, 1), mp, bias, _p8(out),
                             _pi64(np.ascontiguousarray(out_offs)))
        return out
    matT = transpose_mat(mat) if mat.flags.c_contiguous and mat.size else \
        np.ascontiguousarray(mat.T)
    lib.unpack_lanes(_pu32(matT), _pi64(np.ascontiguousarray(lens)),
                     len(lens), W, max(S, 1), mp, bias, _p8(out),
                     _pi64(np.ascontiguousarray(out_offs)))
    return out


def compact_lanes(ebufs: np.ndarray, eptrs: np.ndarray, low: np.ndarray,
                  counts: np.ndarray, CB: int, flush_bytes: int):
    """Dense per-chunk emission buffers -> (payload [W, maxlen], lens[W])."""
    NC, W = eptrs.shape
    eptrs = np.ascontiguousarray(eptrs, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    totals = eptrs.sum(axis=0, dtype=np.int64)
    act = counts > 0
    maxlen = int((totals[act].max() if act.any() else 0) + flush_bytes)
    payload = np.zeros((W, max(maxlen, 1)), dtype=np.uint8)
    lens = np.zeros(W, dtype=np.int64)
    r = lib.compact_lanes(_p8(np.ascontiguousarray(ebufs)), _pi32(eptrs),
                          _pu32(np.ascontiguousarray(low, dtype=np.uint32)),
                          _pi64(counts), NC, W, CB, flush_bytes,
                          _p8(payload), max(maxlen, 1), _pi64(lens))
    if r < 0:
        raise RuntimeError("compact_lanes overflow")
    return payload[:, :maxlen], lens


def seqx_encode(src: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                wa: int, rec_bad: np.ndarray | None = None,
                nbad: int | None = None) -> list[np.ndarray]:
    """Run-length non-ACGT exception lane streams (format v2). With
    rec_bad (per-record exception counts from pack_lanes), clean records
    are skipped without rescanning their bytes. nbad (total exception
    bases, also from pack_lanes) tightens the arena bound: the blanket
    worst-case arena is ~13 bytes/sequence-byte (86 MB at 64k records),
    whose page-zeroing alone cost ~15 ms/block."""
    n = len(offs)
    total = int(np.asarray(lens).sum())
    # Strides must bound ONE lane, since a skewed input can concentrate
    # every exception in a single aux lane (records r % wa == w). <=32 B
    # covers the worst varint triple + char per run, and runs <= bad
    # bases, so 32*nbad + 64 is a true single-lane bound; without nbad
    # the unconditional bound is 32 B per sequence byte. The balanced
    # estimate (13 B per lane-share of the bytes) goes first so the
    # common case never touches a huge arena; np.empty is lazily mapped,
    # so even the fallback rung only faults in the pages it writes.
    stride_est = 13 * (total // max(wa, 1)) \
        + 13 * ((n + wa - 1) // max(wa, 1)) + 64
    bound = 32 * nbad + 64 if nbad is not None else 32 * total + 64
    ladder = [min(stride_est, bound)]
    if ladder[-1] < bound:
        ladder.append(bound)
    rb = _pi32(np.ascontiguousarray(rec_bad, dtype=np.int32)) \
        if rec_bad is not None else \
        ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    for st in ladder:
        arena = np.empty(wa * st, dtype=np.uint8)
        sizes = np.zeros(wa, dtype=np.int64)
        r = lib.seqx_encode(_p8(src), _pi64(np.ascontiguousarray(offs)),
                            _pi64(np.ascontiguousarray(lens)), n, wa,
                            _p8(arena), st, _pi64(sizes), rb)
        if r >= 0:
            return [arena[w * st: w * st + sizes[w]].copy()
                    for w in range(wa)]
    raise RuntimeError("seqx_encode overflow")  # unreachable: bound rung


def seqx_apply(lane_bufs: list[np.ndarray], fmt: int, n: int,
               rec_starts: np.ndarray, rec_lens: np.ndarray,
               out: np.ndarray) -> None:
    """Parse the aux-lane SEQX exception streams and patch the exception
    chars into the record-major sequence buffer in place (decode twin of
    seqx_encode; replaces the Python parse_seqx_lane loop, ~10 ms/64k
    block). Raises ValueError on a malformed stream or out-of-bounds
    patch position."""
    bufs = [np.ascontiguousarray(b, dtype=np.uint8) for b in lane_bufs]
    sizes = np.array([len(b) for b in bufs], dtype=np.int64)
    ptrs, _keep = _bufptrs(bufs)
    r = lib.seqx_apply(ptrs, _pi64(sizes), len(bufs), fmt, n,
                       _pi64(np.ascontiguousarray(rec_starts)),
                       _pi64(np.ascontiguousarray(rec_lens)), _p8(out))
    if r < 0:
        raise ValueError("corrupt SEQX exception stream")


def scan_bad(src: np.ndarray, offs: np.ndarray, lens: np.ndarray):
    """Per-record non-ACGT base counts + total (read-only census for the
    device-pack path; the pack itself happens on the TPU)."""
    n = len(offs)
    rec_bad = np.zeros(max(n, 1), dtype=np.int32)
    nbad = lib.scan_bad(_p8(src), _pi64(np.ascontiguousarray(offs)),
                        _pi64(np.ascontiguousarray(lens)), n,
                        _pi32(rec_bad))
    return int(nbad), rec_bad[:n]


def minmax_ranges(src: np.ndarray, offs: np.ndarray, lens: np.ndarray):
    mn = np.zeros(1, dtype=np.int64)
    mx = np.zeros(1, dtype=np.int64)
    lib.minmax_ranges(_p8(src), _pi64(np.ascontiguousarray(offs)),
                      _pi64(np.ascontiguousarray(lens)), len(offs),
                      _pi64(mn), _pi64(mx))
    return int(mn[0]), int(mx[0])


def fastq_assemble(n: int, id_arena, id_off, id_len, seq_buf, seq_off,
                   qual_buf, lengths, plus_arena, plus_off,
                   plus_len, sx_lanes=None, fmt: int = 3) -> memoryview:
    """Returns a zero-copy memoryview of the assembled FASTQ bytes (the
    earlier np.zeros + .tobytes() pattern cost ~19 ms per 16 MB block:
    a full zeroing pass plus a full copy).

    sx_lanes: optional SEQX exception lane streams — patched into the
    ASSEMBLED output's seq fields (offsets are closed-form from the
    record layout), so `seq_buf` can be a read-only view and the caller
    never pays a writable copy of the sequence bytes just to patch a
    handful of exception runs."""
    cap = int(id_len.sum() + plus_len.sum() + 2 * lengths.sum() + 5 * n + 16)
    out = np.empty(cap, dtype=np.uint8)
    r = lib.fastq_assemble(n, _p8(id_arena), _pi64(id_off), _pi64(id_len),
                           _p8(seq_buf), _pi64(seq_off), _p8(qual_buf),
                           _pi64(lengths), _p8(plus_arena), _pi64(plus_off),
                           _pi64(plus_len), _p8(out), cap)
    if r < 0:
        raise RuntimeError("fastq_assemble overflow")
    if sx_lanes is not None and any(len(b) for b in sx_lanes) and n:
        lengths = np.ascontiguousarray(lengths, dtype=np.int64)
        sizes = 5 + np.asarray(id_len) + 2 * lengths + np.asarray(plus_len)
        op = np.empty(n, dtype=np.int64)
        op[0] = 0
        np.cumsum(sizes[:-1], out=op[1:])
        out_seq_off = op + 2 + id_len   # '@' + id + '\n'
        seqx_apply(sx_lanes, fmt, n, out_seq_off, lengths, out)
    return memoryview(out[:r].data)


def flags_reorder(grouped: np.ndarray, n: int, wa: int) -> np.ndarray:
    """Lane-grouped flag triples -> record-order [3n] (C++ gather; the
    NumPy fancy-index scatter cost ~0.9 ms per 64k block)."""
    out = np.empty(3 * max(n, 1), dtype=np.uint8)
    lib.flags_reorder(_p8(np.ascontiguousarray(grouped)), n, wa, _p8(out))
    return out[: 3 * n]


def match_find_arrays(data: np.ndarray, seq_off: np.ndarray,
                      seq_len: np.ndarray, min_score: int):
    """Format v5 long-range matcher (C++ twin of models/matcher.py
    find_matches, sampling under the same matcher.sample_mask(); equality
    pinned by tests/test_torch_matcher.py). Returns (ref, orient, v,
    score) int64/uint8 arrays with ref < 0 for unmatched reads — the
    production-path representation (the per-read tuple list of
    match_find cost ~50 ms/64k block in Python object churn; measured
    round 5). Raises MemoryError when the library cannot allocate, and
    OverflowError when the candidate arena would pass the 2^29 entries a
    slot can address; there is no fallback."""
    n = len(seq_off)
    ref = np.empty(n, dtype=np.int64)
    orient = np.empty(n, dtype=np.uint8)
    v = np.empty(n, dtype=np.int64)
    score = np.empty(n, dtype=np.int64)
    r = lib.match_find(_p8(data), _pi64(np.ascontiguousarray(seq_off)),
                       _pi64(np.ascontiguousarray(seq_len)), n, min_score,
                       sample_mask(), _pi64(ref), _p8(orient), _pi64(v),
                       _pi64(score))
    if r == -1:
        raise MemoryError("match_find: the candidate arena's realloc "
                          "failed")
    if r == -3:
        raise MemoryError("match_find: out of memory")
    if r == -2:
        raise OverflowError("match_find: the candidate arena passes the "
                            "2^29 entries a slot's block field holds")
    return ref, orient, v, score


def match_find(data: np.ndarray, seq_off: np.ndarray, seq_len: np.ndarray,
               min_score: int) -> list:
    """List-of-tuples view of match_find_arrays (oracle-comparison
    surface for tests/tools). Returns per read None or
    (ref, orient, v, score)."""
    ref, orient, v, score = match_find_arrays(data, seq_off, seq_len,
                                              min_score)
    n = len(ref)
    return [None if ref[r] < 0
            else (int(ref[r]), int(orient[r]), int(v[r]), int(score[r]))
            for r in range(n)]


def match_encode_lanes(m_arrs, min_score: int, n: int, wa: int) -> list:
    """Per-aux-lane MATCH descriptor streams from match arrays —
    byte-identical to models/matcher.py encode_match_lanes (pinned by
    tests/test_match.py)."""
    refs, orients, vs, scores = m_arrs
    per_lane = (n + wa - 1) // wa if n else 0
    stride = 30 * max(per_lane, 1)
    arena = np.empty(wa * stride, dtype=np.uint8)
    sizes = np.empty(wa, dtype=np.int64)
    r = lib.match_encode_lanes(
        _pi64(np.ascontiguousarray(refs)),
        _p8(np.ascontiguousarray(orients)),
        _pi64(np.ascontiguousarray(vs)),
        _pi64(np.ascontiguousarray(scores)), n, min_score, wa,
        _p8(arena), stride, _pi64(sizes))
    assert r == 0, "match lane stride overflow (cannot happen: 30 B cap)"
    return [arena[w * stride: w * stride + sizes[w]] for w in range(wa)]


def match_mflag(recs: np.ndarray, los: np.ndarray, his: np.ndarray,
                lengths: np.ndarray, W: int, S: int) -> np.ndarray:
    """[S, W] match-span flag matrix from span arrays — fused C++
    replacement for pack_lanes(span_flags_flat(...)) (bit-identical;
    the numpy chain cost ~60-80 ms/64k block inside the pipeline)."""
    n = len(lengths)
    if S == 0:
        return np.zeros((0, W), dtype=np.uint8)
    matT = np.empty((W, S), dtype=np.uint8)
    lib.match_mflag(_pi64(np.ascontiguousarray(recs)),
                    _pi64(np.ascontiguousarray(los)),
                    _pi64(np.ascontiguousarray(his)), len(recs),
                    _pi64(np.ascontiguousarray(lengths)), n, W, S,
                    _p8(matT))
    return transpose_mat(matT)


def match_apply_arrays(dst: np.ndarray, src: np.ndarray,
                       seq_off: np.ndarray, seq_len: np.ndarray,
                       m_arrs, min_score: int) -> None:
    """Rewrite matched spans of dst with e-transform letters (encode
    side; refs read from the unmodified src buffer)."""
    refs, orients, vs, scores = m_arrs
    lib.match_apply(_p8(dst), _p8(src),
                    _pi64(np.ascontiguousarray(seq_off)),
                    _pi64(np.ascontiguousarray(seq_len)), len(seq_off),
                    _pi64(np.ascontiguousarray(refs)),
                    _p8(np.ascontiguousarray(orients)),
                    _pi64(np.ascontiguousarray(vs)),
                    _pi64(np.ascontiguousarray(scores)), min_score)


def match_apply(dst: np.ndarray, src: np.ndarray, seq_off: np.ndarray,
                seq_len: np.ndarray, matches: list, min_score: int) -> None:
    """List-of-tuples front end of match_apply_arrays."""
    n = len(seq_off)
    ref = np.full(n, -1, dtype=np.int64)
    orient = np.zeros(n, dtype=np.uint8)
    v = np.zeros(n, dtype=np.int64)
    score = np.zeros(n, dtype=np.int64)
    for r, m in enumerate(matches):
        if m is not None:
            ref[r], orient[r], v[r], score[r] = m
    match_apply_arrays(dst, src, seq_off, seq_len,
                       (ref, orient, v, score), min_score)


def match_parse(m_lanes: list, wa: int, n: int):
    """Parse decoded MATCH descriptor lanes into record-sorted arrays
    (recs, refs, orients, vs). Raises ValueError on a corrupt stream."""
    bufs = [np.ascontiguousarray(b, dtype=np.uint8) for b in m_lanes]
    sizes = np.array([len(b) for b in bufs], dtype=np.int64)
    ptrs, _keep = _bufptrs(bufs)
    recs = np.empty(max(n, 1), dtype=np.int64)
    refs = np.empty(max(n, 1), dtype=np.int64)
    orients = np.empty(max(n, 1), dtype=np.uint8)
    vs = np.empty(max(n, 1), dtype=np.int64)
    m = lib.match_parse(ptrs, _pi64(sizes), wa, n, _pi64(recs),
                        _pi64(refs), _p8(orients), _pi64(vs))
    if m < 0:
        raise ValueError("corrupt MATCH descriptor stream")
    return recs[:m], refs[:m], orients[:m], vs[:m]


def match_reconstruct_arrays(seq_bytes: np.ndarray, rec_starts: np.ndarray,
                             lengths: np.ndarray, m_arr) -> np.ndarray:
    """Decode-side v5 reconstruction from parsed descriptor arrays: undo
    the e-transform on a copy of the record-major letter buffer."""
    out = np.array(seq_bytes, dtype=np.uint8, copy=True)
    recs, refs, orients, vs = m_arr
    lib.match_reconstruct_arrays(
        _p8(out), _pi64(np.ascontiguousarray(rec_starts)),
        _pi64(np.ascontiguousarray(lengths)),
        _pi64(np.ascontiguousarray(recs)),
        _pi64(np.ascontiguousarray(refs)),
        _p8(np.ascontiguousarray(orients)),
        _pi64(np.ascontiguousarray(vs)), len(recs))
    return out
