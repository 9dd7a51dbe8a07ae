"""The format's lane coder in plain PyTorch, for the benchmark's check.

A frozen copy of the normative bit format (the port's NumPy oracle,
``ops/ranger.py`` and ``ops/streams_np.py``), trimmed to the encode of
the QUAL, SEQ and byte kinds and given a step limit: ``encode_streams``
codes the first ``steps`` lockstep symbol-steps of a stream and returns
each lane's bytes emitted so far. The range coder never takes back a
byte it has emitted, so those bytes are the first bytes of the lane's
payload in the container whatever follows. Where the stream has no more
steps than the limit the lanes are flushed and the whole payload
returned.

It runs on the device it is given, one symbol-step at a time, every
state tensor updated in place; on a CUDA card a few symbol-steps are
captured once as a CUDA graph and replayed, each stream on a CUDA
stream of its own, so a block's streams take seconds, not minutes.
Unsigned 32-bit words are int64 masked to 32 bits; the table is int32,
whose collision count wraps as the format's.

The coding law: a carry-less 32-bit range coder with byte
renormalisation codes every symbol through a balanced binary tree of
12-bit adaptive probabilities; W lanes advance in lockstep and share
one table; in a bit-step every lane reads the table as it stood before
the step, the updates merge by addition (a collision count in bits
22-31 scales each delta down) and touched entries are clamped; from a
visit-count warm-up (0 < rate_lo < rate) cold entries adapt faster.
Every lane with a symbol codes ``pad_steps(S)`` steps; steps past its
own count code symbol 0 in the sacrificial context.
"""

from __future__ import annotations

import numpy as np
import torch

TOP = 1 << 24
BOT = 1 << 16
PROB_BITS = 12
PROB_ONE = 1 << PROB_BITS
PROB_INIT = PROB_ONE // 2
PROB_MIN = 16
PROB_MAX = PROB_ONE - PROB_MIN
CAP_LOG2 = 4
CNT_SHIFT = 22
RENORM_ITERS = 4
FLUSH_BYTES = 4
STEP_BUCKET = 256
MASK32 = 0xFFFFFFFF
# symbol-steps a CUDA graph holds, replayed over the stream
GRAPH_STEPS = 8


def pad_steps(S: int) -> int:
    """Lockstep steps coded for a block whose longest lane has S."""
    return 0 if S <= 0 else -(-S // STEP_BUCKET) * STEP_BUCKET


def _ceil_log2_table() -> list:
    """ceil(log2(c)) capped at 10, for c = 0 .. 1,025 (every count the
    law asks it of)."""
    return [sum(1 for j in range(10) if c > (1 << j)) for c in range(1026)]


class Geom:
    """One stream's model geometry: kind ``qual``, ``seq`` or ``byte``
    and the sizes the container header and the block state."""

    def __init__(self, kind: str, **g):
        self.kind = kind
        self.g = g
        self.rate = int(g["rate"])
        self.rate_lo = int(g.get("rate_lo", 0))
        if kind == "qual":
            self.depth = int(g["depth"])
            self.num_ctx = 1 << (self.depth + g["q2_bits"]
                                 + g["delta_bits"] + g["pos_bits"])
        elif kind == "seq":
            self.depth = 2
            self.tree_ctx = ((1 << (2 * (g["order"] + 1))) - 1) // 3
            mb = int(g.get("match_bits", 0))
            self.num_ctx = self.tree_ctx + ((1 << mb) if mb else 0)
        else:
            self.depth = 8
            self.num_ctx = 256 if g["order"] else 1
        nodes = (1 << self.depth) - 1
        self.sac_base = self.num_ctx * nodes
        self.table_size = (self.num_ctx + 1) * nodes


class _Stream:
    """A stream's whole coding state on one device. ``step()`` codes the
    next symbol-step in place, reading the step's row by a counter on
    the device, so one capture of it serves every step."""

    def __init__(self, geom: Geom, syms, counts, pos, reset, run: int,
                 device):
        i64 = dict(dtype=torch.int64, device=device)
        W = len(counts)
        self.geom, self.W = geom, W

        def rows(a):  # [run, W], zeros past the stream's rows
            out = np.zeros((run, W), dtype=np.int64)
            if a is not None:
                k = min(run, a.shape[0])
                out[:k] = a[:k]
            return torch.as_tensor(out).to(device)
        self.syms, self.pos, self.reset = rows(syms), rows(pos), rows(reset)
        self.counts = torch.as_tensor(np.asarray(counts, np.int64)).to(device)
        self.t = torch.zeros(1, **i64)
        self.table = torch.full((geom.table_size,), PROB_INIT,
                                dtype=torch.int32, device=device)
        self.table[geom.sac_base:] = PROB_MAX
        self.vtable = (torch.zeros(geom.table_size, dtype=torch.int32,
                                   device=device)
                       if 0 < geom.rate_lo < geom.rate else None)
        self.lg = torch.tensor(_ceil_log2_table(), dtype=torch.int32,
                               device=device)
        self.cap = run * geom.depth + 2 * FLUSH_BYTES + 16
        # one more column: where a lane that emits nothing writes
        self.out = torch.zeros((W, self.cap + 1), dtype=torch.uint8,
                               device=device)
        self.ptr = torch.zeros(W, **i64)
        self.low = torch.zeros(W, **i64)
        self.rng = torch.full((W,), MASK32, **i64)
        self.a = torch.zeros(W, **i64)
        self.b = torch.zeros(W, **i64)
        self.lanes = torch.arange(W, **i64)
        if geom.kind == "seq":
            k = geom.g["order"]
            self.mask = (1 << (2 * k)) - 1
            self.offsets = torch.tensor(
                [((1 << (2 * j)) - 1) // 3 for j in range(k + 1)], **i64)

    def _row(self, a):
        return a.index_select(0, self.t).view(self.W)

    def _ctx(self, pos, reset):
        geom, g = self.geom, self.geom.g
        if geom.kind == "byte":
            return self.a if g["order"] else torch.zeros_like(self.a)
        rs = reset != 0
        self.a.masked_fill_(rs, 0)
        if geom.kind == "seq":
            j = torch.clamp(pos, max=g["order"])
            return self.a + self.offsets[j]
        self.b.masked_fill_(rs, 0)
        ctx, shift = self.a, geom.depth
        if g["q2_bits"]:
            ctx = ctx | ((self.b >> (geom.depth - g["q2_bits"])) << shift)
            shift += g["q2_bits"]
        if g["delta_bits"]:
            diff = self.a - self.b
            dc = torch.where(diff == 0, 0, torch.where(
                (diff > 0) & (diff <= 3), 1,
                torch.where((diff < 0) & (diff >= -3), 2, 3)))
            ctx = ctx | (dc << shift)
            shift += g["delta_bits"]
        if g["pos_bits"]:
            posb = torch.clamp(pos >> g["pos_shift"],
                               max=(1 << g["pos_bits"]) - 1)
            ctx = ctx | (posb << shift)
        return ctx

    def _advance(self, sym) -> None:
        if self.geom.kind == "seq":
            self.a.copy_(((self.a << 2) | sym) & self.mask)
        else:
            self.b.copy_(self.a)
            self.a.copy_(sym)

    def _bit(self, p, bit) -> None:
        low, rng = self.low, self.rng
        split = (rng >> PROB_BITS) * p
        is1 = bit != 0
        low = torch.where(is1, (low + split) & MASK32, low)
        rng = torch.where(is1, (rng - split) & MASK32, split)
        for _ in range(RENORM_ITERS):
            agree = ((low ^ (low + rng)) & MASK32) < TOP
            do = agree | (rng < BOT)
            rng = torch.where(do & ~agree, (-low) & (BOT - 1), rng)
            col = torch.where(do, torch.clamp(self.ptr, max=self.cap),
                              self.cap)
            self.out.index_put_((self.lanes, col),
                                (low >> 24).to(torch.uint8))
            self.ptr.add_(do.to(torch.int64))
            low = torch.where(do, (low << 8) & MASK32, low)
            rng = torch.where(do, (rng << 8) & MASK32, rng)
        self.low.copy_(low)
        self.rng.copy_(rng)

    def step(self) -> None:
        geom = self.geom
        live = self.counts > self.t
        ctx = self._ctx(self._row(self.pos), self._row(self.reset))
        ctx = torch.where(live, ctx, geom.num_ctx)
        sym = torch.where(live, self._row(self.syms), 0)
        nodes = (1 << geom.depth) - 1
        base = ctx * nodes
        node = torch.ones_like(base)
        table, vtable, lg = self.table, self.vtable, self.lg
        real = None
        for i in range(geom.depth - 1, -1, -1):
            bit = (sym >> i) & 1
            idx = base + node - 1
            if real is None:
                real = idx < geom.sac_base
                mark = torch.where(real, 1 << CNT_SHIFT, 0).to(torch.int32)
            table.index_add_(0, idx, mark)
            marked = table[idx]
            p32 = torch.clamp(marked & ((1 << CNT_SHIFT) - 1), PROB_MIN,
                              PROB_MAX)
            self._bit(p32.to(torch.int64), bit)
            cnt = marked >> CNT_SHIFT
            r = geom.rate
            if vtable is not None:
                vis = torch.clamp(vtable[idx], max=1024)
                r = torch.clamp(geom.rate_lo + lg[vis + 1], max=geom.rate)
                vtable.index_add_(0, idx, real.to(torch.int32))
            delta = torch.where(bit != 0, -(p32 >> r),
                                (PROB_ONE - p32) >> r)
            delta = delta >> torch.clamp(
                lg[torch.clamp(cnt, min=1)] - CAP_LOG2, min=0)
            table.index_add_(0, idx, torch.where(
                real, delta - (1 << CNT_SHIFT), 0).to(torch.int32))
            now = table[idx]
            table.index_put_((idx,), torch.where(
                real, torch.clamp(now, PROB_MIN, PROB_MAX), now))
            node = 2 * node + bit
        self._advance(sym)
        self.t.add_(1)

    def flush(self) -> None:
        for _ in range(FLUSH_BYTES):
            self.out.index_put_((self.lanes, self.ptr),
                                (self.low >> 24).to(torch.uint8))
            self.ptr.add_(1)
            self.low.copy_((self.low << 8) & MASK32)


def _code(streams: list, runs: list) -> None:
    """Each stream's ``runs[i]`` symbol-steps. On a card each stream
    codes on a CUDA stream of its own, so they run side by side: its
    first two steps eagerly (they warm up every kernel), then a graph of
    GRAPH_STEPS steps replayed, the rest eagerly."""
    dev = streams[0].out.device if streams else None
    if dev is None or dev.type != "cuda":
        for st, n in zip(streams, runs):
            for _ in range(n):
                st.step()
        return
    main = torch.cuda.current_stream(dev)
    sides = [torch.cuda.Stream(dev) for _ in streams]
    graphs = []
    for st, n, side in zip(streams, runs, sides):
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(min(n, 2)):
                st.step()
    torch.cuda.synchronize(dev)
    for st, n, side in zip(streams, runs, sides):
        g = None
        if n - 2 >= GRAPH_STEPS:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=side):
                for _ in range(GRAPH_STEPS):
                    st.step()
        graphs.append(g)
    left = [max(n - 2, 0) for n in runs]
    while any(k >= GRAPH_STEPS for k, g in zip(left, graphs) if g):
        for i, (g, side) in enumerate(zip(graphs, sides)):
            if g is not None and left[i] >= GRAPH_STEPS:
                with torch.cuda.stream(side):
                    g.replay()
                left[i] -= GRAPH_STEPS
    for st, k, side in zip(streams, left, sides):
        with torch.cuda.stream(side):
            for _ in range(k):
                st.step()
    torch.cuda.synchronize(dev)
    del graphs


def encode_streams(jobs: list, steps: int = STEP_BUCKET,
                   device="cpu") -> list:
    """Code the first ``steps`` symbol-steps of each stream of ``jobs``
    on ``device``, the streams side by side.

    A job is (geom, syms, counts, pos, reset): ``syms`` [>= min(steps,
    S), W] (rows past the stream's end ignored), ``counts`` [W] each
    lane's symbols, ``pos``/``reset`` [rows, W] for the qual and seq
    kinds (None for the byte kind). Returns for each job (bytes [W, n]
    uint8, emitted [W], whole) as NumPy arrays: ``whole`` where the
    stream had no more than ``steps`` coded steps, so the lanes were
    flushed and ``emitted`` is each lane's whole payload length (0 for a
    lane with no symbols)."""
    streams, runs, pads = [], [], []
    for geom, syms, counts, pos, reset in jobs:
        counts = np.asarray(counts, dtype=np.int64)
        S = int(counts.max()) if len(counts) else 0
        pads.append(pad_steps(S))
        runs.append(min(pads[-1], steps))
        k = min(runs[-1], S)
        streams.append(_Stream(
            geom, syms[:k], counts, None if pos is None else pos[:k],
            None if reset is None else reset[:k], runs[-1],
            torch.device(device)))
    _code(streams, runs)
    out = []
    for st, n, Sp in zip(streams, runs, pads):
        whole = n == Sp
        if whole:
            st.flush()
            st.ptr.masked_fill_(st.counts <= 0, 0)
        ptr = st.ptr.cpu().numpy()
        if len(ptr) and int(ptr.max()) > st.cap:
            raise RuntimeError("a lane emitted more bytes than the coder "
                               "holds")
        out.append((st.out[:, :st.cap].cpu().numpy(), ptr, whole))
    return out

