"""The port's launch and analysis tools (`repro_torch.launch.{specs,roofline,
cost_analysis,dryrun}`) against the reference's `repro.launch`: shapes, skip
rules, runtime flags and cache lengths equal; `model_flops` equal, exactly;
the roofline arithmetic of tests/test_launch.py under `H100`; cases built on
the meta device; and the dot FLOPs counted on meta equal to the reference's
`analyze_hlo` of the compiled JAX step (1e-3 relative), per family.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun, specs  # noqa: E402
from repro_torch.launch.cost_analysis import StepCost, analyze_case  # noqa: E402
from repro_torch.launch.roofline import H100, derive_roofline, model_flops  # noqa: E402
from repro_torch.launch.specs import SHAPES, ShapeSpec, build_case, skip_reason  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import adamw_init  # noqa: E402

ARCHS = sorted(list_configs())
META = torch.device("meta")
# one arch of each family (dense, vlm, moe, hybrid, ssm, enc-dec), and G = 16
FAMILIES = ["llama2-7b", "glm4-9b", "qwen2-vl-72b", "mixtral-8x22b", "zamba2-7b",
            "xlstm-1.3b", "seamless-m4t-large-v2"]
FLOP_TOL = 1e-3


def smoke_case(arch, kind, seq, batch):
    """A Case of the arch's smoke config (every field replaced)."""
    smoke = get_config(arch, smoke=True)
    fields = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}
    return build_case(arch, ShapeSpec(f"{kind}_{seq}", kind, seq, batch), cfg_kwargs=fields)


def meta_tensors(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in meta_tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# ------------------------------------------------------------------ specs
class TestShapes:
    def test_shapes_and_window_equal_reference(self):
        assert specs.LONG_WINDOW == ref_specs.LONG_WINDOW
        assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
            {k: dataclasses.astuple(v) for k, v in ref_specs.SHAPES.items()}

    def test_assigned_shapes_exact(self):
        assert (SHAPES["train_4k"].seq, SHAPES["train_4k"].batch) == (4096, 256)
        assert (SHAPES["prefill_32k"].seq, SHAPES["prefill_32k"].batch) == (32768, 32)
        assert (SHAPES["decode_32k"].seq, SHAPES["decode_32k"].batch) == (32768, 128)
        assert (SHAPES["long_500k"].seq, SHAPES["long_500k"].batch) == (524288, 1)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_rules_equal_reference(self, arch):
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        for name in SHAPES:
            shape, ref_shape = SHAPES[name], ref_specs.SHAPES[name]
            assert skip_reason(cfg, shape) is None or "documented skip" in skip_reason(cfg, shape)
            assert (skip_reason(cfg, shape) is None) == (ref_specs.skip_reason(ref_cfg, ref_shape)
                                                         is None)
            assert specs.applicable(cfg, shape) == ref_specs.applicable(ref_cfg, ref_shape)
            rt, ref_rt = specs._runtime_for(cfg, shape), ref_specs._runtime_for(ref_cfg, ref_shape)
            assert dataclasses.asdict(rt) == dataclasses.asdict(ref_rt)
            assert specs._cache_len(cfg, shape, rt) == ref_specs._cache_len(ref_cfg, ref_shape,
                                                                             ref_rt)
            # the paper-standard accounting, exactly
            assert model_flops(cfg, shape) == ref_roofline.model_flops(ref_cfg, ref_shape)

    def test_single_documented_skip(self):
        skips = [(a, s) for a in ARCHS for s in SHAPES if skip_reason(get_config(a), SHAPES[s])]
        assert skips == [("seamless-m4t-large-v2", "long_500k")]
        with pytest.raises(ValueError, match="skipped"):
            build_case("seamless-m4t-large-v2", "long_500k")


class TestMetaCases:
    """build_case gives meta tensors only: nothing allocated."""

    @pytest.mark.parametrize("arch,shape", [
        ("glm4-9b", "train_4k"),
        ("mixtral-8x22b", "prefill_32k"),
        ("zamba2-7b", "decode_32k"),
        ("xlstm-1.3b", "long_500k"),
        ("seamless-m4t-large-v2", "decode_32k"),
        ("qwen2-vl-72b", "prefill_32k"),
    ])
    def test_full_size_cases_on_meta(self, arch, shape):
        case = build_case(arch, shape)
        tensors = meta_tensors(case.args)
        assert tensors and all(t.device.type == "meta" for t in tensors)
        assert callable(case.step)

    def test_long500k_dense_gets_window(self):
        # ring cache bounded by the serving window, not 524288
        assert build_case("glm4-9b", "long_500k").args[1]["k"].shape[2] == 8192

    def test_long500k_mixtral_native_swa(self):
        assert build_case("mixtral-8x22b", "long_500k").args[1]["k"].shape[2] == 4096

    def test_long500k_ssm_state_only(self):
        assert "k" not in build_case("xlstm-1.3b", "long_500k").args[1]

    def test_train_batch_shapes(self):
        params, state, batch = build_case("glm4-9b", "train_4k").args
        assert batch["tokens"].shape == (256, 4096) and batch["labels"].shape == (256, 4096)
        assert set(state) == {"mu", "nu", "step"}
        assert all(p.requires_grad for p in params.parameters())

    def test_encdec_prompt_in_config_dtype(self):
        prompt = build_case("seamless-m4t-large-v2", "prefill_32k").args[1]
        assert prompt["enc_embeds"].dtype == torch.bfloat16
        assert prompt["dec_tokens"].dtype == torch.int32


class TestMetaInit:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_meta_init_equals_cpu_init(self, arch):
        model = build_model(get_config(arch, smoke=True))
        meta = [(n, p.shape, p.dtype) for n, p in model.init(device="meta").named_parameters()]
        cpu = [(n, p.shape, p.dtype) for n, p in model.init(device="cpu").named_parameters()]
        assert meta == cpu

    @pytest.mark.parametrize("arch", ARCHS)
    def test_full_size_on_meta_holds_the_reference_parameters(self, arch):
        """Parameters, AdamW moments and a decode cache at full size on
        meta: as many parameters as the reference's tree."""
        model = build_model(get_config(arch))
        params = model.init(device="meta")
        ref_model = ref_build_model(ref_get_config(arch))
        shapes = jax.eval_shape(lambda k: ref_model.init(k)[0], jax.random.PRNGKey(0))
        assert sum(p.numel() for p in params.parameters()) == \
            sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        state = adamw_init(params)
        assert all(m.device.type == "meta" and m.dtype == torch.float32
                   for m in state["mu"].values())
        cache = model.init_cache(2, 64, device="meta", enc_len=8 if model.is_encdec else 0)
        assert all(t.device.type == "meta" for t in meta_tensors(cache))


# --------------------------------------------------------------- roofline
class TestRoofline:
    def test_terms_and_dominance(self):
        cost = StepCost(flops=H100.flops, dot_bytes=H100.hbm_bw * 2, peak_bytes=0, parts={},
                        n_ops=0, collective_bytes={"all-reduce": H100.link_bw * 3})
        r = derive_roofline(cost, get_config("glm4-9b"), SHAPES["train_4k"], chips=256)
        assert r.compute_s == pytest.approx(1.0)
        assert r.memory_s == pytest.approx(2.0)
        assert r.collective_s == pytest.approx(3.0)
        assert r.dominant == "collective"
        assert r.step_s == pytest.approx(6.0)
        d = r.as_dict()
        assert d["dominant"] == "collective" and d["step_s"] == pytest.approx(6.0)

    def test_one_card_has_no_collective_term(self):
        cost = StepCost(flops=1e12, dot_bytes=1e12, peak_bytes=0, parts={}, n_ops=0)
        r = derive_roofline(cost, get_config("llama2-7b"), SHAPES["decode_32k"])
        assert r.chips == 1 and r.collective_s == 0.0 and r.dominant == "memory"
        assert r.useful_ratio == pytest.approx(model_flops(get_config("llama2-7b"),
                                                           SHAPES["decode_32k"]) / 1e12)

    def test_model_flops_conventions(self):
        dense, moe = get_config("glm4-9b"), get_config("mixtral-8x22b")
        t, d = SHAPES["train_4k"], SHAPES["decode_32k"]
        assert model_flops(dense, t) == pytest.approx(6 * dense.param_count() * 256 * 4096)
        assert model_flops(moe, t) == pytest.approx(6 * moe.active_param_count() * 256 * 4096)
        assert model_flops(dense, d) == pytest.approx(2 * dense.param_count() * 128)

    def test_h100_peaks(self):
        assert (H100.flops, H100.flops_f32, H100.hbm_bw, H100.link_bw) == \
            (989e12, 67e12, 3.35e12, 450e9)


# ----------------------------------------------------------- cost analysis
def _jax_dot_flops(arch, kind, B, S, Sc=32):
    """The reference's analyze_hlo of its CPU-compiled smoke step."""
    cfg = ref_get_config(arch, smoke=True)
    model = ref_build_model(cfg)
    params = jax.eval_shape(lambda k: model.init(k)[0], jax.random.PRNGKey(0))
    dt = jnp.dtype(cfg.dtype)
    if kind == "prefill":
        if cfg.n_encoder_layers:
            prompt = {"enc_embeds": jax.ShapeDtypeStruct((B, S, cfg.d_model), dt),
                      "dec_tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        elif cfg.embeds_input:
            prompt = jax.ShapeDtypeStruct((B, S, cfg.d_model), dt)
        else:
            prompt = jax.ShapeDtypeStruct((B, S), jnp.int32)
        lowered = jax.jit(model.prefill).lower(params, prompt)
    else:
        cache = jax.eval_shape(lambda: model.init_cache(B, Sc, enc_len=S)[0])
        tok = jax.ShapeDtypeStruct((B,), jnp.int32)
        lowered = jax.jit(model.decode).lower(params, cache, tok, tok)
    return analyze_hlo(lowered.compile().as_text()).flops


def _port_decode_case(arch, B, S, Sc=32):
    """smoke_case's decode at a cache of Sc slots and S encoder frames."""
    case = smoke_case(arch, "decode", Sc, B)
    if case.model.is_encdec:
        case.args = (case.args[0], case.model.init_cache(B, Sc, device=META, enc_len=S),
                     *case.args[2:])
    return case


class TestCountedFlops:
    @pytest.mark.parametrize("kind", ["prefill", "decode"])
    @pytest.mark.parametrize("arch", FAMILIES)
    def test_equal_reference_analyze_hlo(self, arch, kind):
        B, S = 2, 16
        case = smoke_case(arch, kind, S, B) if kind == "prefill" else _port_decode_case(arch, B, S)
        ours = analyze_case(case).flops
        cache = case.args[1] if kind == "decode" else {}
        theirs = _jax_dot_flops(arch, kind, B, S, Sc=cache["k"].shape[2] if "k" in cache else 32)
        assert ours > 0
        assert abs(ours / theirs - 1.0) <= FLOP_TOL, (ours, theirs)

    @pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
    @pytest.mark.parametrize("arch", FAMILIES)
    def test_memo_changes_nothing_and_flops_are_flop_counter_modes(self, arch, kind):
        """The op memo returns what the ops would: the same FLOPs, traffic,
        peak and parts as running every op; and the FLOPs are
        FlopCounterMode's count of the same step."""
        from torch.utils.flop_counter import FlopCounterMode

        case = smoke_case(arch, kind, 64 if kind == "train" else 16, 2)
        fast, slow = analyze_case(case), analyze_case(case, memo=False)
        assert (fast.flops, fast.dot_bytes, fast.peak_bytes, fast.parts) == \
            (slow.flops, slow.dot_bytes, slow.peak_bytes, slow.parts)
        with FlopCounterMode(display=False) as fc:
            case.step(*case.args)
        assert fast.flops == fc.get_total_flops()

    def test_train_parts_at_the_peak(self):
        """llama2-7b smoke, one AdamW step: parameters, moments and inputs
        count whole; the peak falls in the update, where every gradient is
        live."""
        case = smoke_case("llama2-7b", "train", 64, 2)
        cost = analyze_case(case)
        params, state, batch = case.args
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
        assert cost.parts["params"] == nbytes(params.parameters())
        assert cost.parts["moments"] == nbytes(list(state["mu"].values())
                                               + list(state["nu"].values()) + [state["step"]])
        assert cost.parts["inputs"] == nbytes(batch.values())
        assert cost.parts["grads"] == cost.parts["params"]
        assert cost.parts["cache"] == 0 and cost.parts["other"] > 0
        assert cost.peak_bytes == sum(cost.parts.values())

    def test_refuses_tensors_off_meta(self):
        with pytest.raises(ValueError, match="meta"):
            cost_analysis.analyze_step(lambda x: x, (torch.ones(2),),
                                       {"inputs": torch.ones(2)})


# ------------------------------------------------------------------ dry run
class TestDryRun:
    def test_cli_runs_a_smoke_case(self, tmp_path, monkeypatch):
        smoke = {a: get_config(a, smoke=True) for a in ARCHS}
        monkeypatch.setattr(specs, "get_config", lambda a: smoke[a])
        monkeypatch.setattr(dryrun, "get_config", lambda a: smoke[a])
        tiny = dict(SHAPES, prefill_32k=ShapeSpec("prefill_32k", "prefill", 16, 2))
        monkeypatch.setattr(dryrun, "SHAPES", tiny)
        recs = dryrun.main(["--arch", "glm4-9b", "--shape", "prefill_32k",
                            "--out", str(tmp_path)])
        path = tmp_path / "glm4-9b__prefill_32k__h100.json"
        rec = json.loads(path.read_text())
        assert recs == [rec] and rec["status"] == "ok"
        m = rec["memory"]
        assert m["fits_h100"] and m["peak_gb"] == pytest.approx(
            sum(m[f"{k}_gb"] for k in cost_analysis.PARTS))
        assert rec["roofline"]["chips"] == 1 and rec["roofline"]["collective_s"] == 0.0
        assert rec["cost"]["flops"] == rec["roofline"]["counted_flops_device"] > 0
        # --skip-existing leaves a finished case alone
        assert dryrun.main(["--arch", "glm4-9b", "--shape", "prefill_32k", "--out",
                            str(tmp_path), "--skip-existing"]) == []

    def test_pool_equals_serial(self, tmp_path):
        """run_cases in a spawned pool (phase 8's path) gives the records a
        serial run gives, in the order asked."""
        cases = [("xlstm-1.3b", "long_500k"), ("seamless-m4t-large-v2", "long_500k"),
                 ("glm4-9b", SHAPES["long_500k"], {"n_layers": 2})]
        pooled = dryrun.run_cases(cases, str(tmp_path / "pool"), workers=2)
        serial = dryrun.run_cases(cases, str(tmp_path / "serial"), workers=1)
        assert [r["status"] for r in pooled] == ["ok", "skipped", "ok"]
        for a, b in zip(pooled, serial):
            a.pop("analyze_s", None), b.pop("analyze_s", None)
            assert a == b
        assert pooled[2]["memory"]["params_gb"] < 5.0  # the cut reached the worker (all: 18.8)

    def test_skip_record(self, tmp_path):
        rec = dryrun.run_case("seamless-m4t-large-v2", "long_500k", str(tmp_path))
        assert rec["status"] == "skipped" and "documented skip" in rec["reason"]
        assert json.loads((tmp_path / f"{rec['case']}.json").read_text()) == rec
