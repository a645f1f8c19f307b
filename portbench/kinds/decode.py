"""``decode``: ``pods`` pods of ``sessions`` sessions each, their prompts
of ``prompt`` tokens prefilled in set-up into live caches of ``cache``
positions.  Every step decodes one greedy token for every session of
every pod (the captured pod-step); every ``replicate_every`` steps the
sessions are replicated (pod i's backup holds pod i - 1's).  A turn is
``turn`` tokens and has to outlast the run: a run that would reach a
turn's end raises (a mix whose window ends turns needs their renewal
first).  With ``--trace 1``, ``trace_steps`` steps run under the
profiler after the window, the first of them right after a replication.

A token counts when its step's tokens have reached the host (a copy into
pinned memory, and its event), as a streaming server delivers them.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional

import torch

from portbench import drive
from portbench import program as prog_mod
from portbench import trace as tr
from portbench.drive import AHEAD, Event, Mix, worst
from portbench.reference import common as rc


class Traffic(Mix):
    """A ``decode`` mix."""

    def setup(self, trace: bool) -> None:
        P, B = self.p["pods"], self.p["sessions"]
        S0, C = self.p["prompt"], self.p["cache"]
        if S0 + self.p["turn"] > C:
            raise ValueError("a turn does not fit the cache")
        dev = self.dev
        self.make_weights()
        V = int(self.sizes["vocab"])
        prompts = torch.randint(0, V, (P, B, S0),
                                generator=drive.generator(self.seed, 1, dev),
                                device=dev, dtype=torch.int32)
        prefill = self.prog.prefill_step(B, S0)
        self.live = self.prog.session_cache(P, B, C)
        # fed[p, b, i]: the token fed at position i; served[p, b, i]: the
        # token served from position i (the prediction of i + 1)
        self.fed = torch.zeros((P, B, C), dtype=torch.int32, device=dev)
        self.fed[:, :, :S0] = prompts
        self.served = torch.full((P, B, C), -1, dtype=torch.int32,
                                 device=dev)
        first = []
        for pod in range(P):
            logits, cache = prefill(self.params, {"tokens": prompts[pod]})
            prog_mod.put(self.live, pod, cache)
            del cache
            first.append(torch.argmax(logits[:, -1, :], dim=-1)
                         .to(torch.int32)[:, None])
            del logits
        del prefill
        self.phase("prefill")
        self.tok = torch.stack(first)                           # (P, B, 1)
        self.served[:, :, S0 - 1] = self.tok[..., 0]
        self.step = self.prog.decode_step(P)
        self.replicate = self.prog.replicate_step()
        self.host = [torch.zeros((P, B, 1), dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")
                     for _ in range(AHEAD + 2)]
        self.length = [S0] * P
        self.steps = 0
        self.positions: List[tuple] = []
        # warm: the decode graph (captured on the live sessions, whose
        # addresses it binds) and a replication; the warm steps' tokens
        # are the sessions' first, and the backup a real one
        pending = collections.deque()
        for _ in range(2):
            self._dispatch(pending)
        self.backup = self.replicate(self.live)
        self._drain(pending)
        self.phase("warm")
        self.prog.give_ups()
        if trace and dev.type == "cuda":
            tr.warm_profiler()

    def _dispatch(self, pending) -> None:
        """One decode step of every pod, its tokens sent to the host; a
        replication every R steps."""
        P, B = self.p["pods"], self.p["sessions"]
        if self.length[0] - self.p["prompt"] >= self.p["turn"]:
            raise RuntimeError("a turn ended inside the run")
        for pod in range(P):
            self.fed[pod, :, self.length[pod]] = self.tok[pod, :, 0]
            self.positions.append((self.length[pod], B))
        with tr.span("decode_step"):
            out, self.live = self.step(self.params, self.live, self.tok)
        for pod in range(P):
            self.served[pod, :, self.length[pod]] = out[pod, :, 0]
        self.length = [n + 1 for n in self.length]
        with tr.span("deliver"):
            buf = self.host[self.steps % len(self.host)]
            buf.copy_(out, non_blocking=True)
            pending.append((Event(self.dev), self.steps))
        self.tok = out
        self.steps += 1
        if self.steps % self.p["replicate_every"] == 0:
            with tr.span("replicate"):
                self.backup = self.replicate(self.live)

    def _drain(self, pending, ahead: int = 0) -> None:
        while len(pending) > ahead:
            pending.popleft()[0].wait()

    def window(self, seconds: float) -> None:
        P, B = self.p["pods"], self.p["sessions"]
        last: Optional[float] = None
        self.gaps: List[tuple] = []     # (a step's gap, its tokens)
        self.new_tokens = 0
        pending = collections.deque()

        def deliver():
            nonlocal last
            pending.popleft()[0].wait()
            t = drive.clock()
            self.new_tokens += P * B
            if last is not None:
                self.gaps.append((t - last, P * B))
            last = t
            return t

        t0 = drive.clock()
        deadline = t0 + seconds
        t_last = t0
        while drive.clock() < deadline:
            self._dispatch(pending)
            while len(pending) > AHEAD:
                t_last = deliver()
        while pending:
            t_last = deliver()
        self.attempted = self.new_tokens
        self.e2e = {"decode_tokens_per_s": self.new_tokens / (t_last - t0),
                    "token_gap_p95_ms": _weighted_quantile(self.gaps, 0.95) * 1e3}
        self.readings["window_s"] = t_last - t0

    def _to_replication(self, pending) -> None:
        """Steps until one ends with a replication, all of them done."""
        while self.steps % self.p["replicate_every"]:
            self._dispatch(pending)
            self._drain(pending)
        self._drain(pending)

    def run_stretch(self) -> None:
        n = self.p["trace_steps"]
        pending = collections.deque()
        self._to_replication(pending)
        self._dispatch(pending)         # in flight as the profile starts
        first = len(self.positions)

        def body():
            for _ in range(n):
                self._dispatch(pending)
                self._drain(pending, AHEAD)
            self._drain(pending)
        self.profiled(body)
        self.stretch = {"steps": n, "positions": self.positions[first:]}

    def count_failed(self) -> None:
        V = int(self.sizes["vocab"])
        s = self.served
        self.failed = int(((s < -1) | (s >= V)).sum())

    # -- correct ------------------------------------------------------------
    def take(self) -> dict:
        """The replication's and the lengths' exact checks, then what the
        reference needs (the sampled sessions' tokens as fed and as
        served), copied out; the program's state is then dropped."""
        P, B, S0 = self.p["pods"], self.p["sessions"], self.p["prompt"]
        # right after a replication, pod i's backup holds pod i - 1's
        # sessions as they are: every element of every leaf
        self._to_replication(collections.deque())
        drive.sync(self.dev)
        checks = {"backup_diff": 0.0, "length_diff": 0.0}
        for path, b in prog_mod.leaves(self.backup):
            x = prog_mod.at(self.live, path)
            for pod in range(P):
                checks["backup_diff"] += _unlike(b[(pod + 1) % P], x[pod])
        lengths = self.live["length"].tolist()
        checks["length_diff"] += sum(abs(a - n) for a, n in
                                     zip(lengths, self.length))
        picks = []
        for pod in range(P):            # one session from each half
            for half in (0, 1):
                lo, hi = half * B // 2, max(half * B // 2 + 1,
                                            (half + 1) * B // 2)
                picks.append((pod, self.rng.randrange(lo, hi)))
        picks = sorted(set(picks))[:self.p["check_sessions"]]
        out = {"checks": checks, "sessions": []}
        for pod, b in picks:
            n = self.length[pod]
            out["sessions"].append({
                "tokens": self.fed[pod, b, :n].clone(),
                "served": self.served[pod, b, S0 - 1:n].clone(),
                "from": S0 - 1})
        del self.step, self.live, self.backup
        return out

    def judge(self, got: dict, control: bool) -> Dict[str, dict]:
        """The widest gap by which a served token's logit lies below the
        reference's best, over every served token of the sampled
        sessions; beside it the replication's and lengths' exact
        checks."""
        sides = {"program": dict(got["checks"])}
        if control:
            sides["control"] = {}
        for s in got["sessions"]:
            n = s["tokens"].shape[0]
            at = list(range(s["from"], n))
            want, _ = self.ref.forward(self.params, self.sizes, s["tokens"],
                                       at)
            worst(sides["program"], "token_gap",
                  float(rc.gap_of(want, s["served"]).max()))
            if control:
                low, _ = self.ref.forward(self.params, self.sizes,
                                          s["tokens"], at, low=True)
                worst(sides["control"], "token_gap",
                      float(rc.gap_of(want, low.argmax(-1)).max()))
                del low
            del want
        return sides


def _unlike(a: torch.Tensor, b: torch.Tensor) -> float:
    """Elements of ``a`` and ``b`` that differ (all of them where the
    shapes do), a leading slice at a time."""
    if a.shape != b.shape:
        return float(max(a.numel(), b.numel()))
    if a.dim() == 0:
        return float(a != b)
    return float(sum(int((x != y).sum()) for x, y in zip(a, b)))


def _weighted_quantile(pairs, q: float) -> float:
    """The q-quantile of values given as (value, count) pairs (the lower
    of the two order statistics it falls between)."""
    if not pairs:
        return float("nan")
    pairs = sorted(pairs)
    total = sum(n for _, n in pairs)
    rank = q * (total - 1)
    seen = 0
    for v, n in pairs:
        seen += n
        if seen > rank:
            return v
    return pairs[-1][0]
