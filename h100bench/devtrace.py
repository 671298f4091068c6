"""The device timeline of a traced capture, joined to the spans that
launched each operation.

The join is a copy of the arithmetic of the program's
``explain.join_device_ops`` (kept here so that a change to the program
cannot move the yardstick): each device operation of a
``torch.profiler`` chrome trace (``cat`` ``kernel``, ``gpu_memcpy``,
``gpu_memset``) is matched to the host launch of the same
``args.correlation`` (``cuda_runtime`` / ``cuda_driver``), and charged to
every ``user_annotation`` span whose host range holds that launch. The
harness wraps each traced pair in a :data:`PAIR_SPAN`; the program's own
spans (``t0_fft_yz``, ``t2_exchange_slab``...) nest inside it.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

#: The span the harness opens around each traced forward-backward pair.
PAIR_SPAN = "bench_pair"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

#: Kernels the port wrote: its namespaces (``radix``, ``fuse``) and its
#: units' anonymous namespaces, demangled or mangled. Everything else on
#: the card that is not NCCL's is a library's: PyTorch's elementwise ops
#: and copies, cuFFT.
PORT_KERNEL = re.compile(
    r"^(void )?(radix::|fuse::|\(anonymous namespace\)::)"
    r"|^_ZN(5radix|4fuse|12_GLOBAL__N_1)")


@dataclass(frozen=True)
class Op:
    """One device operation: its name, category, start and length on the
    device (microseconds), the traced pair whose span launched it (None
    outside every pair) and the names of the spans around its launch,
    outermost first."""

    name: str
    cat: str
    ts: float
    dur: float
    pair: int | None
    spans: tuple[str, ...]
    launch: float | None


def op_class(op: Op) -> str:
    """``nccl``, ``port`` (a kernel the port wrote) or ``library``."""
    if "nccl" in op.name.lower():
        return "nccl"
    if op.cat == "kernel" and PORT_KERNEL.search(op.name):
        return "port"
    return "library"


def stage_key(name: str) -> str | None:
    """The ``t0``..``t3`` key of a program span, or None: ``t0_fft_yz``
    -> t0, ``t2_exchange_slab``, ``t2a_exchange_ici[1]`` -> t2,
    ``t3_fft_x[4]`` -> t3; a ``cc<j>:`` prefix is dropped first."""
    if name.startswith("cc"):
        head, sep, rest = name.partition(":")
        if sep and head[2:].isdigit():
            name = rest
    if len(name) >= 2 and name[0] == "t" and name[1] in "0123":
        rest = name[2:]
        if not rest or rest[0] in "_[" or rest[:1] in ("a", "b"):
            return name[:2]
    return None


@dataclass
class Timeline:
    """The ops of one capture and the traced pairs' window on the card."""

    ops: list[Op]
    pairs: int
    host_ops: list[tuple[float, float, str]]

    def pair_ops(self) -> list[Op]:
        return [o for o in self.ops if o.pair is not None]

    def per_pair_counts(self) -> list[int]:
        counts = [0] * self.pairs
        for o in self.pair_ops():
            counts[o.pair] += 1
        return counts

    def complete(self) -> bool:
        """Every traced pair has device operations, and as many as each
        other: a capture that lost records (seen at the start of a window
        on the H100) fails this."""
        counts = self.per_pair_counts()
        return bool(counts) and min(counts) > 0 and min(counts) == max(counts)

    def window(self) -> tuple[float, float] | None:
        """From the start of the traced pairs' first device operation to
        the end of their last (microseconds)."""
        ops = self.pair_ops()
        if not ops:
            return None
        return min(o.ts for o in ops), max(o.ts + o.dur for o in ops)

    def busy(self) -> float:
        """Microseconds of the window in which any operation ran on the
        card (the union of their intervals, any stream)."""
        win = self.window()
        if win is None:
            return 0.0
        lo, hi = win
        total, cur_lo, cur_hi = 0.0, None, None
        for o in sorted(self.ops, key=lambda o: o.ts):
            a, b = max(o.ts, lo), min(o.ts + o.dur, hi)
            if b <= a:
                continue
            if cur_hi is None or a > cur_hi:
                if cur_hi is not None:
                    total += cur_hi - cur_lo
                cur_lo, cur_hi = a, b
            else:
                cur_hi = max(cur_hi, b)
        if cur_hi is not None:
            total += cur_hi - cur_lo
        return total

    def gaps(self) -> list[tuple[float, Op]]:
        """Each idle stretch inside the window (microseconds) with the
        operation that ends it."""
        win = self.window()
        if win is None:
            return []
        lo, hi = win
        out, reach = [], lo
        for o in sorted(self.ops, key=lambda o: o.ts):
            if o.ts + o.dur <= lo or o.ts >= hi:
                continue
            if o.ts > reach:
                out.append((o.ts - reach, o))
            reach = max(reach, o.ts + o.dur)
        return out

    def host_doing(self, t: float | None) -> str:
        """What the host was doing at ``t``: the innermost span around it
        and the innermost ``cpu_op`` (an aten op) around it."""
        if t is None:
            return "unknown"
        inner = [n for (a, b, n) in self.host_ops if a <= t <= b]
        return " > ".join(inner[-2:]) if inner else "outside spans"


def _short(name: str) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:160]


def breakdown(tl: Timeline) -> dict:
    """The ten device operations that took most time in the traced pairs
    and the ten largest sums of idle time by what the host was doing, in
    seconds (the contract's ``breakdown``)."""
    by_op: dict[str, float] = {}
    for o in tl.pair_ops():
        key = _short(o.name)
        by_op[key] = by_op.get(key, 0.0) + o.dur / 1e6
    by_gap: dict[str, float] = {}
    for dur, o in tl.gaps():
        key = tl.host_doing(o.launch)
        by_gap[key] = by_gap.get(key, 0.0) + dur / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def parse(doc) -> Timeline | None:
    """The :class:`Timeline` of a chrome trace document (a dict with
    ``traceEvents`` or the list itself); None for a document that is not
    a trace."""
    raw = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    if not isinstance(raw, list):
        return None
    entries = [e for e in raw if isinstance(e, dict) and "ts" in e]
    annos = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     str(e.get("name", "")))
                    for e in entries if e.get("cat") == "user_annotation"),
                   key=lambda s: (s[0], -s[1]))
    cpu_ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                str(e.get("name", "")))
               for e in entries if e.get("cat") == "cpu_op"]
    pairs = [s for s in annos if s[2] == PAIR_SPAN]
    starts = [s[0] for s in pairs]
    inside: list[list] = [[] for _ in pairs]
    for s in annos:
        if s[2] == PAIR_SPAN:
            continue
        i = bisect.bisect_right(starts, s[0]) - 1
        if i >= 0 and s[1] <= pairs[i][1]:
            inside[i].append(s)
    launch = {}
    for e in entries:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch[corr] = float(e["ts"])
    ops = []
    for e in entries:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch.get((e.get("args") or {}).get("correlation"))
        pair, names = None, ()
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= pairs[i][1]:
                pair = i
                names = tuple(n for a, b, n in inside[i] if a <= t <= b)
        ops.append(Op(str(e.get("name", "")), str(e["cat"]), float(e["ts"]),
                      float(e.get("dur", 0.0)), pair, names, t))
    host = sorted(annos + cpu_ops, key=lambda s: (s[0], -s[1]))
    return Timeline(ops, len(pairs), host)
