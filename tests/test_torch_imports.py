"""The port stands alone: it imports neither JAX nor anything of `repro`,
and its entry points run on the card unless the caller asks for the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro\b(?!_))",
    re.MULTILINE,
)

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."))
print(json.dumps({"imported": names, "forbidden": bad}))
"""


def test_importing_every_module_pulls_in_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == []
    for mod in ("repro_torch.kernels.ops", "repro_torch.serving.icc",
                "repro_torch.launch.serve", "repro_torch.convert",
                "repro_torch.configs.glm4_9b", "repro_torch.configs.nemotron_4_15b",
                "repro_torch.configs.qwen1_5_110b", "repro_torch.configs.mistral_large_123b",
                "repro_torch.configs.qwen2_vl_72b", "repro_torch.models.moe",
                "repro_torch.configs.mixtral_8x22b", "repro_torch.configs.llama4_scout_17b_a16e",
                "repro_torch.core.simulator", "repro_torch.core.capacity",
                "repro_torch.control.arrivals", "repro_torch.telemetry.recorder",
                "repro_torch.launch.capacity", "repro_torch.models.mamba2",
                "repro_torch.models.xlstm", "repro_torch.models.encdec",
                "repro_torch.configs.zamba2_7b", "repro_torch.configs.xlstm_1_3b",
                "repro_torch.configs.seamless_m4t_large_v2", "repro_torch.training",
                "repro_torch.training.optimizer", "repro_torch.training.data",
                "repro_torch.training.checkpoint", "repro_torch.training.loop",
                "repro_torch.launch.train", "repro_torch.launch.roofline",
                "repro_torch.launch.specs", "repro_torch.launch.cost_analysis",
                "repro_torch.launch.dryrun", "repro_torch.faults",
                "repro_torch.faults.spec", "repro_torch.faults.schedule",
                "repro_torch.control.controllers", "repro_torch.control.mobility",
                "repro_torch.control.policy", "repro_torch.telemetry.chrome",
                "repro_torch.telemetry.metrics", "repro_torch.batching",
                "repro_torch.batching.kv_cache", "repro_torch.batching.node",
                "repro_torch.network", "repro_torch.network.scenarios",
                "repro_torch.network.fleet", "repro_torch.network.topology",
                "repro_torch.network.routing", "repro_torch.network.simulator",
                "repro_torch.telemetry.report", "repro_torch.experiments",
                "repro_torch.experiments.__main__", "repro_torch.experiments.bench_docs",
                "repro_torch.experiments.cache", "repro_torch.experiments.dispatch",
                "repro_torch.experiments.progress", "repro_torch.experiments.registry",
                "repro_torch.experiments.result", "repro_torch.experiments.runlog",
                "repro_torch.experiments.runner", "repro_torch.experiments.spec",
                "repro_torch.experiments.suites", "repro_torch.experiments.validate"):
        assert mod in res["imported"]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")] + ["chip_smoke.py"]
))
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), FORBIDDEN.search(text).group(0)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestEntryPointsNeedTheCard:
    def _model(self):
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.models import build_model

        cfg = dataclasses.replace(get_config("llama2-7b", smoke=True), dtype="float32")
        return build_model(cfg)

    def test_model_init(self, no_card):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            self._model().init(seed=0)
        assert self._model().init(seed=0, device="cpu").embed.device.type == "cpu"

    def test_init_cache(self, no_card):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            self._model().init_cache(2, 8)

    def test_convert(self, no_card):
        from repro_torch.convert import convert_cache

        cache = {"k": np.zeros((1, 1, 2, 1, 4), np.float32),
                 "v": np.zeros((1, 1, 2, 1, 4), np.float32),
                 "pos": np.full((1, 2), -1, np.int32)}
        with pytest.raises(RuntimeError, match="device='cpu'"):
            convert_cache(cache)
        assert convert_cache(cache, device="cpu")["pos"].dtype == torch.int32

    def test_engine(self, no_card):
        from repro_torch.serving import InferenceEngine

        m = self._model()
        p = m.init(seed=0, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceEngine(m, p, max_batch=1, max_seq=8)
        assert InferenceEngine(m, p, max_batch=1, max_seq=8, device="cpu").n_active == 0

    def test_serve_cli(self, no_card, monkeypatch):
        from repro_torch.launch import serve

        monkeypatch.setattr(sys, "argv", ["serve"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main()

    def test_train_cli(self, no_card):
        from repro_torch.launch import train

        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--steps", "1"])

    def test_train_loop_defaults_to_the_card(self, no_card):
        from repro_torch.training import AdamWConfig, DataConfig, train_loop

        m = self._model()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_loop(m, DataConfig(vocab_size=m.cfg.vocab_size, seq_len=4, batch_size=1),
                       AdamWConfig(), n_steps=1, log_fn=lambda s: None)

    def test_capacity_cli_measured(self, no_card):
        from repro_torch.launch import capacity

        with pytest.raises(RuntimeError, match="device='cpu'"):
            capacity.main(["--service", "measured"])

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        from repro_torch.kernels.rmsnorm import rmsnorm

        with pytest.raises(ValueError, match="on the card"):
            rmsnorm(torch.ones(2, 8), torch.ones(8))
