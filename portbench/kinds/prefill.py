"""``prefill``: ``pods`` pods of ``sessions`` sessions each.  Every round,
each pod in turn prefills a batch of ``prompt`` tokens a session (drawn
from the seed, ``pool`` batches a pod, used in turn), its cache is copied
into the pod's live session cache and its first greedy token read.  With
``--trace 1``, ``trace_prefills`` pod prefills run under the profiler
after the window.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import torch

from portbench import drive
from portbench import program as prog_mod
from portbench import trace as tr
from portbench.drive import AHEAD, Event, Mix, corner, session, worst
from portbench.reference import common as rc


class Traffic(Mix):
    """A ``prefill`` mix."""

    def setup(self, trace: bool) -> None:
        P, B, S = self.p["pods"], self.p["sessions"], self.p["prompt"]
        self.make_weights()
        V = int(self.sizes["vocab"])
        self.pool = torch.randint(
            0, V, (self.p["pool"], P, B, S), device=self.dev,
            generator=drive.generator(self.seed, 1, self.dev),
            dtype=torch.int32)
        self.step = self.prog.prefill_step(B, S)
        self.live = self.prog.session_cache(P, B, S)
        self.round = 0
        self.firsts: List[torch.Tensor] = []
        self.last: Dict[int, tuple] = {}
        for pod in range(P):            # warm: the cell's one shape
            self._one(pod)
        self.phase("warm")
        self.prog.give_ups()
        self.firsts.clear()
        self.round = 0
        if trace and self.dev.type == "cuda":
            tr.warm_profiler()

    def _one(self, pod: int) -> None:
        batch = self.round % self.p["pool"]
        with tr.span("prefill"):
            logits, cache = self.step(self.params,
                                      {"tokens": self.pool[batch, pod]})
        with tr.span("cache_copy"):
            prog_mod.put(self.live, pod, cache)
        del cache
        first = torch.argmax(logits[:, -1, :], dim=-1)
        self.firsts.append(first)
        self.last[pod] = (batch, logits)

    def window(self, seconds: float) -> None:
        P, B, S = self.p["pods"], self.p["sessions"], self.p["prompt"]
        pending = collections.deque()
        done, t_last = 0, None
        t0 = drive.clock()
        deadline = t0 + seconds
        while True:
            for pod in range(P):
                if drive.clock() >= deadline:
                    break
                self._one(pod)
                self.attempted += B
                pending.append(Event(self.dev))
                while len(pending) > AHEAD:
                    pending.popleft().wait()
                    t_last, done = drive.clock(), done + B * S
            else:
                self.round += 1
                continue
            break
        while pending:
            pending.popleft().wait()
            t_last, done = drive.clock(), done + B * S
        self.e2e = {"prompt_tokens_per_s": done / (t_last - t0)}
        self.readings["window_s"] = t_last - t0

    def run_stretch(self) -> None:
        n = self.p["trace_prefills"]
        P = self.p["pods"]

        def body():
            for i in range(n):
                self._one(i % P)
        self.profiled(body)
        self.stretch = {"prefills": n}

    def count_failed(self) -> None:
        V = int(self.sizes["vocab"])
        firsts = torch.cat(self.firsts) if self.firsts else \
            torch.zeros(0, dtype=torch.long, device=self.dev)
        bad = int(((firsts < 0) | (firsts >= V)).sum())
        for _, logits in self.last.values():
            bad += int((~torch.isfinite(logits.float())).any(-1).sum())
        self.failed = bad

    # -- correct ------------------------------------------------------------
    def take(self) -> dict:
        """What the check needs of the program's outputs, copied out; the
        program's state is then dropped."""
        pod = self.rng.randrange(self.p["pods"])
        batch, logits = self.last[pod]
        out = {"tokens": self.pool[batch, pod].clone(),
               "logits": logits[:, -1, :].float().clone(), "cache": []}
        for b in range(self.p["sessions"]):
            out["cache"].append(session(self.live, pod, b))
        del self.step, self.live, self.pool, self.last, self.firsts
        return out

    def judge(self, got: dict, control: bool) -> Dict[str, dict]:
        """The numbers compared: for every session of the sampled pod's
        last batch, its last logits (whose argmax is the served token)
        and its session cache against the reference's."""
        S = self.p["prompt"]
        sides = {"program": {}, "control": {}} if control else \
            {"program": {}}
        for b, tokens in enumerate(got["tokens"]):
            want, wcache = self.ref.forward(self.params, self.sizes, tokens,
                                            [S - 1], keep_cache=True)
            runs = [("program", got["logits"][b:b + 1],
                     lambda key: got["cache"][b][key])]
            if control:
                low, lcache = self.ref.forward(self.params, self.sizes,
                                               tokens, [S - 1], low=True,
                                               keep_cache=True)
                runs.append(("control", low, lambda key, lc=lcache: lc[key]))
            for side, logits, cache_of in runs:
                r = sides[side]
                worst(r, "logits_err", rc.rel_err(logits, want))
                for key, value in wcache.items():
                    err = rc.rel_err(corner(cache_of(key), value), value)
                    worst(r, "cache_err", err)
                    worst(self.detail.setdefault(side, {}), key[0], err)
            del want, wcache
        return sides
