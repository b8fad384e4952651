"""Structure of the PyTorch port: what it imports, where it runs, how it builds."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import wavecap_tpu_torch
from wavecap_tpu_torch.kernels import build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "wavecap_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_module_imports_without_jax_or_the_jax_package():
    """In a fresh interpreter, importing every module of the port adds no
    ``jax`` and no ``wavecap_tpu`` module to ``sys.modules``."""
    code = (
        "import sys, importlib, json\n"
        "before = set(sys.modules)\n"
        f"for name in {MODULES!r}: importlib.import_module(name)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    added = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("wavecap_tpu_torch.capture.pipeline", "wavecap_tpu_torch.capture.mesh",
                 "wavecap_tpu_torch.parallel.collectives", "wavecap_tpu_torch.parallel.mesh",
                 "wavecap_tpu_torch.parallel.sharded", "wavecap_tpu_torch.decoders.framer",
                 "wavecap_tpu_torch.decoders.p25_mac"):
        assert name in added
    bad = [m for m in added
           if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "wavecap_tpu"
           or m.startswith("wavecap_tpu.")]
    assert not bad, bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "wavecap_tpu"), (path, name)


def test_kernel_wrappers_have_no_fallback():
    """A CUDA tensor reaches a kernel or an error: the wrappers and the
    launcher hold no ``try``."""
    wrappers = {
        "ops/channelizer.py": {"unpack_arms", "arm_dft"},
        "models/channel_bank.py": {"slot_frontend", "voice_fir"},
        "ops/fir.py": {"strided_fir", "polyphase_resample"},
        "ops/iir.py": {"onepole_filter", "sos_filter", "_k9"},
        "ops/agc.py": {"envelope"},
        "ops/pll.py": {"_loop"},
        "ops/noise.py": {"noise_blanker", "spectral_noise_reduction"},
        "models/p25/c4fm.py": {"c4fm_timing", "launch_timing", "c4fm_scan", "launch_scan"},
        "models/p25/cqpsk.py": {"cqpsk_timing", "cfo_power", "cfo_lines", "cqpsk_scan"},
        "parallel/collectives.py": {"copy_to", "ppermute", "all_to_all_tiled", "all_gather", "scatter",
                                    "replicate"},
        "models/p25/equalizer.py": {"echo_fit", "echo_score", "_k14"},
        "kernels/build.py": {"launch"},
    }
    for rel, names in wrappers.items():
        tree = ast.parse((PKG / rel).read_text())
        found = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert names <= set(found), (rel, names - set(found))
        for name in names:
            assert not any(isinstance(n, ast.Try) for n in ast.walk(found[name])), (rel, name)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from wavecap_tpu_torch import convert
    from wavecap_tpu_torch.capture import pipeline
    from wavecap_tpu_torch.models import channel_bank
    from wavecap_tpu_torch.ops import channelizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mode = ("nbfm", (("filter_impl", "fir"), ("fast_discriminator", True)))
    cfg = pipeline.CapturePipelineConfig(
        sample_rate=1_000_000, block_size=16_000, narrow_modes=(mode,),
        channel_bandwidth=12_500.0, audio_rate=25_000,
    )
    calls = [
        lambda **kw: pipeline.pipeline_init(cfg, **kw),
        lambda **kw: pipeline.control_init(cfg, **kw),
        lambda **kw: channelizer.channelizer_init(cfg.channelizer(), **kw),
        lambda **kw: channel_bank.bank_init(cfg.bank_cfg(mode), **kw),
        lambda **kw: channel_bank.assignment_init(4, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
    mixed = pipeline.CapturePipelineConfig(
        sample_rate=1_000_000, block_size=20_000, narrow_modes=("am", "sam", "usb"),
        channel_bandwidth=12_500.0, wide_capacity=2, wide_groups=((),),
    )
    calls += [
        lambda **kw: pipeline.pipeline_init(mixed, **kw),
        lambda **kw: pipeline.control_init(mixed, **kw),
        lambda **kw: pipeline.wide_init(mixed.wide_cfg(), **kw),
        lambda **kw: pipeline.wide_assignment_init(2, **kw),
    ]
    for call in calls[-4:]:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
    from wavecap_tpu_torch.capture.mesh import build_mesh
    from wavecap_tpu_torch.parallel import make_mesh

    for call in (lambda **kw: make_mesh(1, 1, **kw), lambda **kw: build_mesh("stream=1,time=1", **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        assert call(device="cpu").devices[0, 0] == torch.device("cpu")
    state = pipeline.pipeline_init(cfg, device="cpu")
    assert state.chan_state.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.capture_state_from_numpy(cfg, {"chan_state": None, "banks": {}, "wide": None,
                                               "p25": None, "p25p2": None})


def test_build_targets_sm90a_without_fast_math():
    cmd = build.nvcc_command(Path("a.cu"), Path("liba.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
    assert not any("fast" in c and "math" in c for c in cmd)
    assert not any(c.startswith(("-use_fast_math", "--use_fast_math", "-ftz", "-prec")) for c in cmd)
    assert build.BUILD_DIR.relative_to(ROOT).as_posix() + "/" in (ROOT / ".gitignore").read_text()
    stems = {stem for stem, _, _ in build.KERNELS.values()}
    assert stems == {p.stem for p in build.CSRC.glob("*.cu")}
    for src in build.CSRC.glob("*.cu"):
        text = src.read_text()
        # the note each kernel carries: what it replaces, what bounds it
        assert "Bound on the H100" in text and "Replaces" in text and "wavecap_tpu/" in text, src


def test_launch_counts_start_at_zero_and_reset():
    build.reset_launch_counts()
    counts = build.launch_counts()
    assert set(counts) == {"K1_unpack_arms", "K2_arm_dft", "K3_slot_frontend", "K4_voice_fir",
                           "K5_resample_poly", "K7_strided_fir", "K9_iir_cascade", "K10_pll",
                           "K11a_noise_blanker", "K11b_nr_frames", "K11b_nr_gain",
                           "K11b_nr_overlap_add", "K12_c4fm_timing", "K13_cqpsk_timing",
                           "K12s_c4fm_scan", "K13s_cqpsk_scan", "K13_cfo_power", "K13_cfo_lines",
                           "K14_echo_fit"}
    assert not any(counts.values())


def test_package_sets_full_f32():
    assert wavecap_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path, where):
    """No CUDA card here: the script exits non-zero and prints no result;
    a directory that holds only the script fails the same way."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_registry_gives_the_six_analog_modes():
    """Every analog mode builds its state and demodulates a block, and so
    do the two P25 soft-symbol modes; with its noise options (K11) on, a
    mode demodulates the block too, and a constant carrier (nothing to
    blank, no noise to reduce) comes out as without them."""
    from wavecap_tpu_torch.models import registry

    for mode in ("wbfm", "nbfm", "am", "sam", "usb", "lsb"):
        spec = registry.get_demod(mode)
        cfg = registry.make_config(mode, 25_000)
        if mode in ("usb", "lsb"):
            assert cfg.mode == mode
        audio, _ = spec.demod(torch.ones(500, dtype=torch.complex64), spec.init(cfg, device="cpu"), cfg)
        assert audio.shape == (960,) and torch.isfinite(audio).all()
        for opt in ("enable_noise_blanker", "enable_noise_reduction"):
            if opt in cfg.__dataclass_fields__:
                ncfg = registry.make_config(mode, 25_000, **{opt: True})
                got, _ = spec.demod(torch.ones(500, dtype=torch.complex64), spec.init(ncfg, device="cpu"), ncfg)
                assert got.shape == (960,) and torch.isfinite(got).all()
                if opt == "enable_noise_blanker":
                    torch.testing.assert_close(got, audio, rtol=0, atol=0)
    for mode in ("p25-soft", "p25-cqpsk-soft"):
        spec = registry.get_demod(mode)
        cfg = registry.make_config(mode, 48_000)
        soft, state = spec.demod(torch.ones(4800, dtype=torch.complex64), spec.init(cfg, device="cpu"), cfg)
        assert soft.shape == (480,) and torch.isfinite(soft).all() and state.pos.shape == ()


def test_p25_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from wavecap_tpu_torch.capture import pipeline
    from wavecap_tpu_torch.models.p25 import c4fm, cqpsk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pipeline.CapturePipelineConfig(
        sample_rate=1_200_000, block_size=120_000, channel_bandwidth=25_000.0, p25_capacity=2,
        p25_modulation="cqpsk", p25p2_capacity=2,
    )
    calls = [
        lambda **kw: pipeline.pipeline_init(cfg, **kw),
        lambda **kw: pipeline.control_init(cfg, **kw),
        lambda **kw: pipeline.p25_init(cfg, **kw),
        lambda **kw: pipeline.p25p2_init(cfg, **kw),
        lambda **kw: c4fm.c4fm_init(c4fm.C4fmConfig(), **kw),
        lambda **kw: cqpsk.cqpsk_init(cqpsk.CqpskConfig(), **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        call(device="cpu")
    state = pipeline.pipeline_init(cfg, device="cpu")
    assert state.chan_state is not None  # the P25 banks alone still channelize
    assert state.p25.c4fm.cfo_phase.dtype == torch.uint32
