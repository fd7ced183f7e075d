"""The port stands alone: it imports without JAX and without the ``repro``
package, its CUDA paths refuse CPU tensors, and it never falls back to the
CPU on its own."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok', len(" + repr(mods) + "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + sorted((ROOT / "tools").glob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_cuda_paths_refuse_cpu_tensors():
    from repro_torch import engine
    from repro_torch.kernels.event_conv.kernel import (event_conv_cuda,
                                                      event_conv_int8_cuda)
    from repro_torch.kernels.event_matmul.kernel import (
        event_matmul_cuda, event_matmul_int8_cuda)
    from repro_torch.kernels.event_pool.kernel import (event_pool_cuda,
                                                       event_pool_window_cuda)
    from repro_torch.kernels.fire_compact.kernel import fire_compact_cuda

    cfg = engine.EngineConfig(backend="cuda")
    x = torch.zeros((1, 8, 8, 8))
    w = torch.zeros((3, 3, 8, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine.conv2d(x, w, cfg=cfg, padding=1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine.fire(x.reshape(64, 8), cfg)
    s = engine.EventStream.encode_nhwc(x, blk_k=8, blk_m=8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        engine.maxpool2d(s, 2, 2, cfg=cfg)
    i32 = torch.zeros((1, 1), dtype=torch.int32)
    vals = torch.zeros((1, 1, 8, 8))
    codes = torch.zeros((1, 1, 8, 8), dtype=torch.int8)
    scale, zp = torch.ones(()), torch.zeros((), dtype=torch.int32)
    calls = [
        lambda: event_matmul_int8_cuda(codes, i32, i32[0], scale, zp,
                                       torch.zeros((8, 8))),
        lambda: event_conv_int8_cuda(codes, i32, i32[0], i32[0], i32, i32,
                                     scale, zp, torch.zeros((8, 8)), nkb=1),
        lambda: fire_compact_cuda(torch.zeros((8, 8)), blk_m=8, blk_k=8),
        lambda: event_matmul_cuda(vals, i32, i32[0], torch.zeros((8, 8))),
        lambda: event_conv_cuda(vals, i32, i32[0], i32[0], i32, i32,
                                torch.zeros((8, 8)), nkb=1),
        lambda: event_pool_cuda(vals, i32, i32, i32, i32, nkb=1),
        lambda: event_pool_window_cuda(vals, i32, i32[0], i32, i32, nkb=1,
                                       row_stride=1),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()


def test_block_backend_refuses_cuda_operands():
    from repro_torch import engine

    block = engine.EngineConfig(backend="block")
    assert block.resolve_backend(torch.device("cpu")) == "block"
    with pytest.raises(ValueError, match="'block' needs CPU tensors"):
        block.resolve_backend(torch.device("cuda"))
    with pytest.raises(ValueError, match="'block' needs CPU tensors"):
        block.resolve_backend(torch.device("cpu"), torch.device("cuda:0"))
    auto = engine.EngineConfig()
    assert auto.resolve_backend(torch.device("cuda")) == "cuda"
    assert auto.resolve_backend(torch.device("cpu")) == "block"


def test_default_device_never_falls_back():
    from repro_torch import default_device
    from repro_torch.models import cnn

    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="GPU"):
        default_device()
    with pytest.raises(RuntimeError, match="GPU"):
        cnn.cnn_forward([None], torch.zeros((1, 2, 2, 3)),
                        cnn.CNNSpec("pool", 2, 3, (cnn.PoolSpec(),)))


def test_int8_configs_construct_and_run_on_cpu_tensors():
    """``EngineConfig(int8_events=True)`` and
    ``FireConfig(quantize_to_int8=True)`` build and drive a fire -> linear
    chain on CPU tensors: int8 codes with QParams between the layers."""
    from repro_torch import engine
    from repro_torch.core.fire import FireConfig, fire

    cfg = engine.EngineConfig(int8_events=True, blk_k=8)
    assert cfg.int8_events and cfg.int8_bits == 8
    fc = FireConfig(quantize_to_int8=True)
    gen = torch.Generator().manual_seed(0)
    acc = torch.randn((16, 32), generator=gen)
    w = torch.randn((32, 8), generator=gen)
    s = engine.fire(acc, cfg)
    assert s.events.values.dtype == torch.int8 and s.qparams is not None
    y = engine.linear(s, w, cfg=cfg)
    yt = engine.linear(fire(acc, fc), w, cfg=cfg)
    assert y.dtype == torch.float32 and torch.equal(y, yt)


@pytest.mark.parametrize("bits", [4, 16])
def test_int8_bits_other_than_8_are_refused(bits):
    """The int8 kernels take 8-bit codes only, so a config asking for
    another width is refused when it is built, on every device."""
    from repro_torch import engine

    with pytest.raises(ValueError, match="8-bit codes only"):
        engine.EngineConfig(int8_events=True, int8_bits=bits)
    with pytest.raises(ValueError, match="8-bit codes only"):
        engine.EngineConfig().replace(int8_bits=bits)
