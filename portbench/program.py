"""The system under test, as the benchmark drives it: the port's serving
entry points (``repro_torch.launch.serve``) and its counters.  Nothing
else of the program is imported, and nothing of it runs in the
references.
"""
from __future__ import annotations

import re

import torch

# configuration key (the reference's sizes) -> the program's value
_DENSE = {"layers": "num_layers", "d_model": "d_model", "heads": "num_heads",
          "kv_heads": "num_kv_heads", "head_dim": "resolved_head_dim",
          "d_ff": "d_ff", "vocab": "vocab_size", "rope_theta": "rope_theta",
          "norm_eps": "norm_eps"}


def _as_run(arch) -> dict:
    """The program's architecture in the reference's terms."""
    out = {k: getattr(arch, v) for k, v in _DENSE.items()}
    if arch.ssm is not None:
        out.pop("layers")
        out.update(mamba_layers=arch.num_layers, every=arch.shared_attn_every,
                   expand=arch.ssm.expand, ssm_head_dim=arch.ssm.head_dim,
                   state=arch.ssm.state_dim, conv_width=arch.ssm.conv_width,
                   ssd_chunk=arch.ssm.chunk_size,
                   window=arch.sliding_window)
    return out


class Program:
    """``arch``: the program's ``ArchConfig`` (the registry's, by the
    configuration's ``program.arch``, unless given, as the CPU tests give
    a small one); its sizes must equal the reference's."""

    def __init__(self, config: dict, sizes: dict, device, arch=None):
        from repro_torch.configs import get_arch
        from repro_torch.launch import serve
        self.serve = serve
        self.arch = arch or get_arch(config["program"]["arch"])
        self.device = torch.device(device)
        got = _as_run(self.arch)
        differ = {k: (got.get(k), v) for k, v in sizes.items()
                  if float(got.get(k) or 0) != float(v or 0)}
        if differ:
            raise ValueError(f"the program's {self.arch.name} differs from "
                             f"the configuration: {differ}")

    def param_shapes(self) -> dict:
        """The program's serving parameters: leaf path -> (shape, dtype)
        (its tree on the meta device)."""
        return {path: (tuple(x.shape), x.dtype) for path, x in
                leaves(self.serve.params_shape_tree(self.arch))}

    def prefill_step(self, batch: int, seq: int):
        from repro_torch.configs import AttnImpl, ShapeConfig, StepKind
        shape = ShapeConfig("portbench", seq, batch, StepKind.PREFILL)
        return self.serve.make_prefill_step(self.arch, shape,
                                            impl=AttnImpl.FLASH,
                                            device=self.device)

    def decode_step(self, pods: int):
        return self.serve.make_decode_step(self.arch, n_pods=pods,
                                           device=self.device)

    def replicate_step(self):
        return self.serve.make_replicate_sessions_step(device=self.device)

    def session_cache(self, pods: int, batch: int, length: int) -> dict:
        """``pods`` pods' zeroed session caches of ``batch`` sessions and
        ``length`` positions, stacked on a leading pod dim."""
        from repro_torch.models import model_zoo
        one = model_zoo.init_cache(self.arch, batch, length,
                                   device=self.device)
        return stack(one, pods)

    def give_ups(self) -> int:
        """Flash give-ups since the last read (0 where no flash kernel
        ran: the CPU)."""
        if self.device.type != "cuda":
            return 0
        from repro_torch.kernels.flash_attention.kernel import \
            check_give_ups
        try:
            return check_give_ups()
        except RuntimeError as e:
            return sum(int(n) for n in re.findall(r"(\d+) on cuda", str(e)))


def stack(tree, pods: int):
    if isinstance(tree, dict):
        return {k: stack(v, pods) for k, v in tree.items()}
    return torch.stack([tree] * pods)


def leaves(tree, path: str = ""):
    """(path, tensor) of every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def put(live: dict, pod: int, cache: dict) -> None:
    """A pod's prefill ``cache`` into the leading corner of its slot of the
    pod-stacked ``live`` tree (positions past the prompt stay as they
    are)."""
    for path, src in leaves(cache):
        dst = at(live, path)[pod]
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)

