"""Port parity at the tile edges of the Hopper flash kernels, and the
contracts between the CUDA sources and their Python wrappers.

The bf16 flash kernels run 128-row q blocks and kv tiles (forward) and
128 kv rows against 64- or 32-row q tiles (dK/dV), so the plain versions
they are held to on the card are checked here against the JAX reference
kernels at sequence lengths on both sides of those edges: the plain
forward against ``_fwd_call`` and the blocked plain backward against
``_bwd_pallas``, both in interpret mode as tests/test_pallas.py runs
them, in f32 at the reference's own tolerances.  Inputs come from numpy
seeds.

The other tests read the CUDA sources: every ``extern "C"`` launcher
must match the ctypes ``argtypes`` its wrapper binds (a mismatch passes
garbage with no error), and every ``__global__`` kernel must fall into
its hand-written family in ``profile._family``.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu.ops.pallas.attention import _bwd_pallas, _fwd_call
from kungfu_tpu_torch import profile
from kungfu_tpu_torch.ops.cuda import _build, attention
from kungfu_tpu_torch.ops.cuda import collectives as ring_kernels
from kungfu_tpu_torch.ops.cuda import lm_head as lm_head_kernels
from kungfu_tpu_torch.ops.cuda.attention import (
    flash_attention_backward_reference, flash_attention_reference)

#: the reference kernel's own tolerances (tests/test_pallas.py): forward
#: against plain attention, backward between two blocked backwards on the
#: same saved (out, lse)
F32_ATOL = 2e-5
GRAD_ATOL_BLOCKED = 2e-4

EDGE_SEQS = (1, 65, 129, 257)
EDGE_DIMS = (32, 64, 128)


def _inputs(s, d, seed, n=3, bh=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(bh, s, d)).astype(np.float32)
                 for _ in range(n))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", EDGE_DIMS)
@pytest.mark.parametrize("s", EDGE_SEQS)
def test_plain_forward_matches_jax_kernel_at_tile_edges(s, d, causal):
    arrs = _inputs(s, d, seed=100 + s + d)
    ref_o, ref_lse = _fwd_call(*(jnp.asarray(a) for a in arrs), causal,
                               128, 128, True)
    got_o, got_lse = flash_attention_reference(
        *(torch.from_numpy(a) for a in arrs), causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(ref_o), atol=F32_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(ref_lse),
                               atol=F32_ATOL)


@pytest.mark.parametrize("d", EDGE_DIMS)
@pytest.mark.parametrize("s", EDGE_SEQS)
def test_blocked_backward_matches_jax_kernel_at_tile_edges(s, d):
    """Causal, with the dK/dV kernel's tiles on the JAX side (64-row q
    blocks, 128-row kv blocks); both on the JAX forward's (out, lse)."""
    q, k, v, do = _inputs(s, d, seed=200 + s + d, n=4)
    out, lse = _fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         True, 128, 128, True)
    ref = _bwd_pallas(*(jnp.asarray(a) for a in (q, k, v)), out, lse,
                      jnp.asarray(do), True, 64, 128, True)
    got = flash_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do), True)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=GRAD_ATOL_BLOCKED, err_msg=f"d{name}")


# ------------------------------------------------ sources and wrappers --

CSRC = Path(_build.CSRC)

_C_KINDS = (("long long", "i64"), ("float", "float"), ("int", "int"))
_CTYPES_KINDS = {ctypes.c_int: "int", ctypes.c_float: "float",
                 ctypes.c_longlong: "i64", ctypes.c_void_p: "ptr"}


def _c_kind(param: str) -> str:
    if "*" in param:
        return "ptr"
    for c_type, kind in _C_KINDS:
        if re.search(rf"\b{c_type}\b", param):
            return kind
    raise AssertionError(f"unknown C parameter type: {param!r}")


def _ctypes_kind(t) -> str:
    if t in _CTYPES_KINDS:
        return _CTYPES_KINDS[t]
    assert issubclass(t, ctypes._Pointer), f"unknown ctypes type {t}"
    return "ptr"


def _launchers():
    """{(source, name): [parameter kinds]} of every extern "C" function."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C"\s+[\w\s\*]+?\b(kf_\w+)\s*\(([^)]*)\)',
                             text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            found[(src.name, m.group(1))] = [_c_kind(p) for p in params]
    return found


class _FakeFn:
    argtypes = None
    restype = None


class _FakeLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("kf_"):
            return self.fns.setdefault(name, _FakeFn())
        raise AttributeError(name)


def test_launchers_match_wrapper_argtypes(monkeypatch):
    libs = {}

    def fake_build(source):
        libs[source] = _FakeLib()
        return _build.Built(libs[source], CSRC / source, 0.0, "")

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(attention, "_built", {})
    monkeypatch.setattr(lm_head_kernels, "_built", None)
    monkeypatch.setattr(ring_kernels, "_built", None)
    for load in (attention.load, attention.load_bwd, lm_head_kernels.load,
                 ring_kernels.load):
        load()

    launchers = _launchers()
    assert {src for src, _ in launchers} == set(libs), \
        "a CUDA source without a wrapper, or a wrapper without a source"
    for (src, name), c_kinds in launchers.items():
        fn = libs[src].fns.get(name)
        assert fn is not None and fn.argtypes is not None, \
            f"{src}:{name} is never bound"
        assert [_ctypes_kind(t) for t in fn.argtypes] == c_kinds, \
            f"{src}:{name} argtypes differ from the C parameters"
    assert {"kf_flash_fwd", "kf_flash_bwd_dq", "kf_flash_bwd_dkv",
            "kf_lm_head_split_w", "kf_lm_head_fwd_wgmma",
            "kf_lm_head_bwd_dh_wgmma", "kf_lm_head_bwd_dw_wgmma",
            "kf_ring_rs", "kf_ring_ag"} <= {name for _, name in launchers}


#: the families whose bf16 path is a wgmma kernel, by source
_WGMMA_FAMILIES = {"flash_fwd.cu": {"flash_fwd"},
                   "flash_bwd.cu": {"flash_bwd_dq", "flash_bwd_dkv"},
                   "lm_head.cu": {"lm_head_fwd", "lm_head_bwd_dh",
                                  "lm_head_bwd_dw"},
                   "ring.cu": set()}


@pytest.mark.parametrize("source,families", [
    ("flash_fwd.cu", {"flash_fwd"}),
    ("flash_bwd.cu", {"flash_bwd_dq", "flash_bwd_dkv"}),
    ("lm_head.cu", {"lm_head_fwd", "lm_head_bwd_dh", "lm_head_bwd_dw",
                    "lm_head_split"}),
    ("ring.cu", {"ring_rs", "ring_ag"}),
])
def test_flash_kernel_names_map_to_their_profile_family(source, families):
    text = (CSRC / source).read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        text)
    assert names, f"no kernels found in {source}"
    seen = set()
    for name in names:
        family = profile._family(name)
        assert family.endswith("(hand-written)"), (name, family)
        seen.add(family.split(" ")[0])
    assert seen == families
    for family in _WGMMA_FAMILIES[source]:
        assert any("wgmma" in n and profile._family(n).startswith(family)
                   for n in names), f"the bf16 wgmma {family} kernel is gone"
