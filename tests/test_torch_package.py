"""The PyTorch port as a package: what it imports, where it runs, what it
refuses.

- ``apex_tpu_torch`` and ``chip_smoke.py`` import no ``jax``, ``flax`` or
  ``apex_tpu`` (an AST scan, so a lazy import inside a function counts);
- entry points and modules run on ``cuda`` unless given
  ``device="cpu"``, and raise without CUDA instead of moving to the host;
- options that belong to later slices, and inputs the kernels do not
  take, raise; a CUDA tensor never takes a plain version;
- gradients flow through the kernels' wrappers and the model.
"""

import ast
import json
import pathlib

import pytest
import torch

from apex_tpu_torch.contrib.group_norm import GroupNorm
from apex_tpu_torch.models.convert import init_gpt2_params
from apex_tpu_torch.models.gpt2 import GPT2, GPT2Config
from apex_tpu_torch.models.resnet import Bottleneck, Conv, ResNet18ish
from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
from apex_tpu_torch.contrib.peer_memory import PeerMemoryPool
from apex_tpu_torch.parallel import RankGroup, SyncBatchNorm, spawn_ranks
from apex_tpu_torch.ops import _build
from apex_tpu_torch.normalization.fused_layer_norm import (
    fused_layer_norm_affine)
from apex_tpu_torch.ops.flash_attention import (flash_attention,
                                                flash_attention_fwd)
from apex_tpu_torch.ops.layer_norm_kernel import ln_fwd
from apex_tpu_torch.serve import cli
from apex_tpu_torch.serve.engine import Engine, EngineConfig
from apex_tpu_torch.serve.kv_cache import init_cache
from apex_tpu_torch.transformer import (MLP, EncdecMultiheadAttn, FusedDense,
                                        FusedDenseGeluDense,
                                        SelfMultiheadAttn)
from apex_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "apex_tpu")
TINY = GPT2Config(vocab_size=64, n_positions=32, n_embd=64, n_layer=1,
                  n_head=1, compute_dtype=torch.float32)


def _port_files():
    files = sorted((ROOT / "apex_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_flax_or_apex_tpu():
    files = _port_files()
    assert len(files) > 15 and all(f.exists() for f in files)
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_device_defaults_to_cuda_and_raises_without_it():
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("build", [
    lambda: GPT2(TINY),
    lambda: Engine(TINY, init_gpt2_params(TINY)),
    lambda: init_cache(1, 2, 8, 1, 64),
    lambda: ResNet18ish(),
    lambda: RankGroup(),
    lambda: spawn_ranks(print, 2),
    lambda: PeerMemoryPool(static_size=1024),
])
def test_entry_points_raise_without_cuda(build):
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


MODULES = {
    "FusedLayerNorm": lambda **kw: FusedLayerNorm(8, **kw),
    "FusedRMSNorm": lambda **kw: FusedRMSNorm(8, **kw),
    "SyncBatchNorm": lambda **kw: SyncBatchNorm(8, **kw),
    "Conv": lambda **kw: Conv(4, 4, 3, **kw),
    "Bottleneck": lambda **kw: Bottleneck(8, 2, **kw),
    "GroupNorm": lambda **kw: GroupNorm(2, 8, **kw),
    "SelfMultiheadAttn": lambda **kw: SelfMultiheadAttn(128, 2, **kw),
    "EncdecMultiheadAttn": lambda **kw: EncdecMultiheadAttn(128, 2, **kw),
    "FusedDense": lambda **kw: FusedDense(8, 4, **kw),
    "FusedDenseGeluDense": lambda **kw: FusedDenseGeluDense(8, 16, 4, **kw),
    "MLP": lambda **kw: MLP([8, 16, 4], **kw),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_modules_default_to_cuda_and_raise_without_it(name):
    """A module built with no device resolves it as every entry point
    does: ``None`` means ``cuda``, which raises without CUDA instead of
    putting the parameters on the host."""
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        MODULES[name]()


@pytest.mark.parametrize("name", sorted(MODULES))
def test_modules_build_on_cpu_when_asked(name):
    module = MODULES[name](device="cpu")
    tensors = list(module.parameters()) + list(module.buffers())
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_entry_points_run_on_cpu_when_asked():
    model = GPT2.from_params(TINY, init_gpt2_params(TINY), device="cpu")
    assert model.device.type == "cpu"
    eng = Engine(TINY, model, EngineConfig(num_slots=2, max_len=16,
                                           temperature=0.0), device="cpu")
    first, _, _ = eng.prefill({0: [1, 2, 3]})
    assert 0 <= int(first[0]) < TINY.vocab_size
    with pytest.raises(ValueError, match="device"):
        Engine(TINY, model, EngineConfig(), device="meta")


def test_cli_raises_without_cuda_and_runs_on_cpu(capsys):
    _require_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--requests", "1"])
    assert cli.main(["--device", "cpu", "--requests", "3", "--num-slots",
                     "2", "--max-new-tokens", "4", "--max-len", "32"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert out["summary"]["completed"] == 3
    assert out["kernel_launches"] == {}


@pytest.mark.parametrize("field,value", [
    ("page_size", 8), ("num_pages", 9), ("prefix_cache", True), ("tp", 2),
    ("spec_draft_len", 2), ("decode_policy", "greedy"),
    ("kv_quant", "int8")])
def test_later_slice_options_raise(field, value):
    cfg = EngineConfig(**{field: value})
    with pytest.raises(NotImplementedError, match=field):
        Engine(TINY, init_gpt2_params(TINY), cfg, device="cpu")


def test_kernels_pass_gradients():
    """Inputs that need a gradient go through the differentiable entry
    points (LayerNorm, flash attention) and get one; the raw forward
    wrappers run under autograd too."""
    x = torch.randn(4, 64, requires_grad=True)
    g = torch.ones(64, requires_grad=True)
    b = torch.zeros(64, requires_grad=True)
    fused_layer_norm_affine(x, g, b, 64).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (x, g, b))
    q = torch.randn(1, 1, 8, 64, requires_grad=True)
    flash_attention(q, q, q, True).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    y, _, _ = ln_fwd(x, g, b, eps=1e-5)
    o, _ = flash_attention_fwd(q, q, q, scale=0.125, causal=True)
    assert y.shape == x.shape and o.shape == q.shape


def test_model_forward_builds_a_graph_to_every_parameter():
    """Parameters are trainable: a plain forward records the graph and
    the loss's gradient reaches every parameter; under no_grad nothing
    is recorded."""
    model = GPT2.from_params(TINY, init_gpt2_params(TINY), device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    logits = model(torch.tensor([[1, 2, 3]]))
    assert logits.shape == (1, 3, TINY.vocab_size) and logits.requires_grad
    logits.square().mean().backward()
    assert all(p.grad is not None for p in model.parameters())
    with torch.no_grad():
        assert not model(torch.tensor([[1, 2, 3]])).requires_grad


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    moved."""
    x, g = torch.empty(4, 64, device="meta"), torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="device"):
        ln_fwd(x, g, g, eps=1e-5)
    q = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention_fwd(q, q, q, scale=0.125, causal=True)


def test_group_norm_wrappers_refuse_other_devices():
    """The GroupNorm kernels' wrappers refuse a tensor that is neither on
    the CPU nor on CUDA."""
    from apex_tpu_torch.ops.group_norm_kernel import (gn_apply, gn_one_pass,
                                                      gn_stats)
    x = torch.empty(2, 64, 16, device="meta")
    s = torch.empty(2, 4, device="meta")
    for call in (lambda: gn_one_pass(x, 4, None, None, eps=1e-5),
                 lambda: gn_stats(x, s, 8),
                 lambda: gn_apply(x, s, s, s, None, None, 8)):
        with pytest.raises(ValueError, match="device"):
            call()


def test_optimizer_wrappers_refuse_other_devices():
    """The flat optimizer kernels' wrappers refuse a tensor that is
    neither on the CPU nor on CUDA."""
    from apex_tpu_torch.ops.fused_adam_kernel import (fused_adam_flat,
                                                      fused_adam_flat_master)
    from apex_tpu_torch.ops.fused_opt_kernels import fused_adagrad_flat
    from apex_tpu_torch.ops.fused_sgd_kernel import fused_sgd_flat
    p = torch.empty(1024, device="meta")
    for call in (lambda: fused_sgd_flat(p, p, p, lr=0.1),
                 lambda: fused_adam_flat(p, p, p, p, lr=0.1),
                 lambda: fused_adam_flat_master(p, p, p, p, lr=0.1),
                 lambda: fused_adagrad_flat(p, p, p, lr=0.1)):
        with pytest.raises(ValueError, match="device"):
            call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_build_sources_and_digest():
    names = [p.name for p in _build.sources()]
    assert names == ["flash_attention.cu", "flash_attention_bwd.cu",
                     "flash_bwd_dkv_wgmma.cu", "flash_bwd_dq_wgmma.cu",
                     "flash_fwd_tf32.cu", "flash_fwd_wgmma.cu",
                     "fused_adagrad.cu", "fused_adam.cu", "fused_lamb.cu",
                     "fused_novograd.cu", "fused_sgd.cu", "group_norm.cu",
                     "layer_norm.cu", "remote_copy.cu", "softmax.cu"]
    assert set(_build.SIGNATURES) == {
        "apex_ln_fwd", "apex_ln_bwd", "apex_fa_fwd", "apex_fa_bwd_dq",
        "apex_fa_bwd_dkv", "apex_fa_bwd_fma_occupancy",
        "apex_fa_fwd_wgmma", "apex_fa_fwd_tf32",
        "apex_fa_fwd_tf32_occupancy", "apex_fa_bwd_dq_wgmma",
        "apex_fa_bwd_dkv_wgmma",
        "apex_fused_adam", "apex_fused_adam_master",
        "apex_lamb_stage1", "apex_lamb_stage2", "apex_fused_sgd",
        "apex_fused_novograd", "apex_fused_adagrad", "apex_gn_one_pass",
        "apex_gn_stats", "apex_gn_apply", "apex_softmax_fwd",
        "apex_softmax_bwd", "apex_ipc_alloc", "apex_ipc_handle",
        "apex_ipc_open", "apex_ipc_close", "apex_ipc_free", "apex_peer_put",
        "apex_halo_put", "apex_peer_wait"}
    assert _build._digest() == _build._digest()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with pytest.raises(RuntimeError, match="cudaError 7"):
        _build.check(7, "x")
    _build.check(0, "x")


def test_softmax_wrappers_refuse_other_devices():
    """The softmax kernels' wrappers refuse a tensor that is neither on
    the CPU nor on CUDA."""
    from apex_tpu_torch.ops.softmax_kernel import softmax_bwd, softmax_fwd
    x = torch.empty(2, 4, 8, device="meta")
    for call in (lambda: softmax_fwd(x, scale=1.0),
                 lambda: softmax_fwd(x, scale=1.0, causal=True),
                 lambda: softmax_bwd(x, x, scale=1.0)):
        with pytest.raises(ValueError, match="device"):
            call()


def _chip_smoke():
    """``chip_smoke.py`` imported as a module, without running ``main()``
    (its top level imports only the standard library)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_call_lines():
    """``{file: {line, ...}}`` of every ``pl.pallas_call`` in the JAX
    package's kernels."""
    out = {}
    for f in sorted((ROOT / "apex_tpu" / "ops" / "pallas").glob("*.py")):
        rel = f.relative_to(ROOT).as_posix()
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if "pl.pallas_call" in line:
                out.setdefault(rel, set()).add(i)
    return out


def test_chip_smoke_kernel_table_names_every_pallas_call():
    """The ``kernels`` line's references: each entry's ``replaces`` is a
    ``def`` line of the JAX package, each of its call lines holds
    ``pl.pallas_call``, its source exists, and the listed calls together
    with the ones still to port are exactly the ``pl.pallas_call`` lines
    of ``apex_tpu/ops/pallas/*.py``: a kernel no row accounts for, or a
    stale line number, fails here."""
    cs = _chip_smoke()
    listed = {}
    for name, (src, tpu, calls) in cs.KERNELS.items():
        assert (ROOT / src).is_file(), (name, src)
        path, line = tpu.rsplit(":", 1)
        lines = (ROOT / path).read_text().splitlines()
        assert lines[int(line) - 1].lstrip().startswith("def "), (name, tpu)
        assert calls, name
        for c in calls:
            assert "pl.pallas_call" in lines[c - 1], (name, path, c)
            listed.setdefault(path, set()).add(c)
    for path, calls in cs.TO_PORT.items():
        assert not listed.get(path, set()) & set(calls), path
        listed.setdefault(path, set()).update(calls)
    assert listed == _pallas_call_lines()
    assert set(cs.KERNELS) == {
        "ln_fwd", "ln_bwd", "fa_fwd", "fa_bwd_dq", "fa_bwd_dkv",
        "fused_adam", "fused_adam_master", "lamb_stage1", "lamb_stage2",
        "fused_sgd", "fused_novograd", "fused_adagrad", "gn_one_pass",
        "gn_stats", "gn_apply", "softmax_fwd", "softmax_fwd_causal",
        "softmax_bwd", "peer_put", "halo_put", "peer_wait"}
    # every TPU kernel has its counterpart: nothing is left to port
    assert cs.TO_PORT == {}


def test_chip_smoke_flash_solo_cases_cover_the_wide_heads():
    """The ``flash-fwd`` / ``flash-bwd`` solo modes' cases: the d = 64
    cases keep the keys of the trees before the wider cases (so two trees
    still compare in turns), and the bf16 cases add Cerebras-GPT 1.3B's
    causal 2 x 16 x 2048 x 128, Cerebras-GPT 2.7B's 2 x 32 x 2048 x 80
    (the padded route) and GPT-J 6B's 2 x 16 x 2048 x 256, each keyed with
    its width; every compiled head dim has a case and every case's head
    dim is one the card serves (at most 256)."""
    cs = _chip_smoke()
    keys = [cs._solo_key(*c) for c in cs._SOLO_CASES]
    assert len(set(keys)) == len(keys)
    assert {"4x12x1024x1024_causal", "bf16_4x12x1024x1024_causal",
            "bf16_4x25x1024x1024_causal", "bf16_32x16x128x128",
            "1025x64x64x64_causal"} <= set(keys)
    assert "bf16_2x16x2048x2048_causal_d128" in keys
    assert "bf16_2x32x2048x2048_causal_d80" in keys
    assert "bf16_2x16x2048x2048_causal_d256" in keys
    assert {c[5] for c in cs._SOLO_CASES} >= {64, 128, 256}
    assert all(c[5] <= 256 for c in cs._SOLO_CASES)
    assert all(c[5] == 64 for c in cs._SOLO_CASES if c[6] == "fp32")


def test_remote_copy_wrappers_refuse_other_devices():
    """The peer-put kernels' wrappers refuse a tensor that is neither on
    the CPU nor on CUDA."""
    from apex_tpu_torch.ops.remote_copy import halo_exchange_rdma, peer_shift
    group = RankGroup(device="cpu")
    x = torch.empty(16, 4, device="meta")
    for call in (lambda: peer_shift(x, group, 1),
                 lambda: halo_exchange_rdma(x, group, 1)):
        with pytest.raises(ValueError, match="device"):
            call()
