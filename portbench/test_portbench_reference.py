"""The references against the program on the CPU at a reduced size (f32,
both on the weights ``portbench.weights`` makes), then the whole harness
on the CPU: a sound run comes out correct, the fp8 control reads well
above it, and a run whose timed path is broken underneath comes out not
correct, once for each fault a cell can have.  About 40 s on one CPU."""
from __future__ import annotations

import itertools

import pytest
import torch

from portbench import drive, program, weights
from portbench.reference import common as rc
from portbench.run import run
from portbench.testing import tiny

PREFILL = ["internlm2-1.8b.prefill_32k", "zamba2-7b.prefill_4k"]
DECODE = ["internlm2-1.8b.decode_1k_replicated",
          "zamba2-7b.decode_2k_replicated"]


@pytest.fixture(autouse=True)
def steady_clock(monkeypatch):
    """The generator's clock advances 50 ms a reading, so a window holds
    the same steps however busy the CPU is; two threads a test."""
    ticks = itertools.count()
    monkeypatch.setattr(drive, "clock", lambda: next(ticks) * 0.05)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["internlm2-1.8b.prefill_32k",
                                  "zamba2-7b.prefill_4k"])
def test_reference_matches_the_program(name):
    """Prefill logits and cache, then three decode steps through that
    cache, the program in f32 against the reference's full forward."""
    from repro_torch.configs import AttnImpl, ShapeConfig, StepKind
    from repro_torch.launch import serve
    cell, arch = tiny(name)
    ref, sizes = cell.reference, cell.sizes
    params = weights.make(ref, sizes, seed=3, device="cpu")
    S, B, steps = 40, 2, 3
    tokens = torch.randint(0, int(sizes["vocab"]), (B, S + steps),
                           generator=torch.Generator().manual_seed(1))
    shape = ShapeConfig("t", S, B, StepKind.PREFILL)
    prefill = serve.make_prefill_step(arch, shape, impl=AttnImpl.FLASH,
                                      device="cpu",
                                      compute_dtype=torch.float32)
    logits, cache = prefill(params, {"tokens": tokens[:, :S]})
    from repro_torch.models import model_zoo
    live = program.stack(model_zoo.init_cache(arch, B, 64, torch.float32,
                                              device="cpu"), 1)
    program.put(live, 0, cache)
    step = serve.make_decode_step(arch, 1, device="cpu",
                                  compute_dtype=torch.float32)
    got = [logits[:, -1]]
    for t in range(steps):
        nxt = tokens[:, S + t:S + t + 1].to(torch.int32)
        got.append(_decode_logits(step, params, live, nxt))
    for b in range(B):
        want, _ = ref.forward(params, sizes, tokens[b],
                              list(range(S - 1, S + steps)))
        mine = torch.stack([g[b] for g in got])
        assert rc.rel_err(mine, want) < 1e-4
        _, wcache = ref.forward(params, sizes, tokens[b, :S], [S - 1],
                                keep_cache=True)
        session = drive.session(program.stack(cache, 1), 0, b)
        for key, value in (wcache or {}).items():
            assert rc.rel_err(drive.corner(session[key], value)
                              .float(), value) < 2e-3, key


def _decode_logits(step, params, live, token):
    """One decode step's logits: the pod-step's eager body with the
    model's head read through a wrapped ``decode_step``."""
    from repro_torch.models import model_zoo
    seen = {}
    orig = model_zoo.decode_step

    def spy(*a, **k):
        out = orig(*a, **k)
        seen["logits"] = out[0][:, -1].float()
        return out
    model_zoo.decode_step = spy
    try:
        step.eager(params, live, token[None])
    finally:
        model_zoo.decode_step = orig
    return seen["logits"]


@pytest.mark.parametrize("name", PREFILL + DECODE)
def test_sound_run_is_correct_and_the_control_is_not(name):
    cell, arch = tiny(name)
    out = run(cell, seed=5, seconds=4.0, trace=False, device="cpu",
              arch=arch, control=True)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    program_side = {k: c["value"] for k, c in out["checks"].items()}
    compared = ("logits_err", "cache_err") if name in PREFILL else \
        ("token_gap",)
    for k in compared:
        assert out["control"][k]["value"] > 3 * program_side[k], (k, out)
    assert not out["control_correct"], out["control"]


class Broken(program.Program):
    """The program with one fault planted under the harness."""

    fault = None

    def prefill_step(self, batch, seq):
        step = super().prefill_step(batch, seq)

        def broken(params, batch_in):
            logits, cache = step(params, batch_in)
            if self.fault == "state_unchanged":
                cache = _zeros(cache)
            elif self.fault == "half_batch":
                # the second half's outputs are the first half's
                n = logits.shape[0]
                logits[n // 2:] = logits[:n - n // 2]
                for path, x in program.leaves(cache):
                    if path != "length" and not path.endswith("_pos"):
                        d = x.dim() - drive.rank(path)
                        x.narrow(d, n // 2, n - n // 2).copy_(
                            x.narrow(d, 0, n - n // 2))
            elif self.fault == "answer_altered":
                logits = logits.roll(1, dims=-1)
            return logits, cache
        return broken

    def decode_step(self, pods):
        step = super().decode_step(pods)

        def broken(params, cache, token):
            if self.fault == "state_unchanged":
                kept = {k: v.clone() for k, v in program.leaves(cache)}
            out, cache = step(params, cache, token)
            if self.fault == "state_unchanged":
                for k, v in kept.items():
                    program.at(cache, k).copy_(v)
            elif self.fault == "half_batch":
                half = out.shape[1] // 2
                out[:, half:] = out[:, :out.shape[1] - half]
            elif self.fault == "answer_altered":
                out = (out + 1) % self.arch.vocab_size
            return out, cache
        return broken

    def replicate_step(self):
        step = super().replicate_step()
        if self.fault == "no_exchange":
            return lambda live: {k: _clone(v) for k, v in live.items()}
        if self.fault == "leaf_not_replicated":
            # the recurrent state (or, with none, the values) left out
            def dropping(live):
                backup = step(live)
                names = {p.split("/")[-1] for p, _ in program.leaves(live)}
                gone = RECURRENT & names or {"v"}
                for path, x in program.leaves(backup):
                    if path.split("/")[-1] in gone:
                        x.zero_()
                return backup
            return dropping
        return step


RECURRENT = {"state", "conv_x", "conv_B", "conv_C"}


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return tree if tree.dim() == 0 else torch.zeros_like(tree)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


FAULTS = [(n, f) for n in PREFILL for f in
          ("state_unchanged", "half_batch", "answer_altered")] + \
    [(n, f) for n in DECODE for f in
     ("state_unchanged", "half_batch", "answer_altered", "no_exchange",
      "leaf_not_replicated")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell, arch = tiny(name)
    prog = Broken(cell.config, cell.sizes, "cpu", arch)
    prog.fault = fault
    out = run(cell, seed=6, seconds=0.5, trace=False, device="cpu",
              program=prog)
    assert not out["correct"], (fault, out["checks"])
