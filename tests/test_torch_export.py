"""The port's export against the JAX package's, on the CPU, at the size of
tests/test_export.py (1 stack, width 16, 64^2, topk 8):

* `export_predict` writes `exported_predict.pt2` and a meta.json with
  every key of the JAX package's meta.json for the same config (the
  shared values equal), no runner package on the CPU, and the kernel and
  op library digests;
* `load_exported` is bit-equal to the eager port predict;
* the port's exported program and the JAX package's (`load_exported(bin)
  .call`) on the same weights (BN state from `bn_scaled`) give detections
  matched both ways (class, IoU >= 0.99, |score difference| <= 1e-3);
* the exported graph calls `helmet.peak_scores` once and
  `helmet.bn_act` / `helmet.bn_add_act` at the architecture's sites, the
  int8 export `quantize_act` / `qconv_dense` / `qconv_dw` at its sites
  (counts derived as chip_smoke.py derives its launches);
* `--export-raw-input` takes uint8 and matches the float program;
* `--export-serve` writes `serving/b<N>` for exactly the JAX package's
  `resolve_buckets` set, each bit-equal to the eager predict at its
  batch; without it there is no `serving/`;
* the int8 export's scales sha256 equals the JAX package's `scales_hash`
  of the saved scales;
* `torch.library.opcheck` passes for each of the six `helmet` ops;
* csrc/torch_ops.cpp defines the same schemas as the Python ops;
* the default device refuses to run without a card; the CLI
  `--export-flag --device cpu` writes the artifacts.
"""

import json
import os
import re
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.export import \
    build_export_fn as jax_build_export_fn
from real_time_helmet_detection_tpu.export import \
    export_predict as jax_export_predict
from real_time_helmet_detection_tpu.export import \
    load_exported as jax_load_exported
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.ops.quant import \
    load_scales as jax_load_scales
from real_time_helmet_detection_tpu.ops.quant import scales_hash
from real_time_helmet_detection_tpu.serving import \
    resolve_buckets as jax_resolve_buckets
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state
from real_time_helmet_detection_tpu_torch.export import (PROGRAM,
                                                         export_predict,
                                                         load_exported)
from real_time_helmet_detection_tpu_torch.ops import library, qconv
from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
from real_time_helmet_detection_tpu_torch.utils import normalize_image
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (repo root: the launch derivations)
from test_torch_predict import (assert_detections_match,  # noqa: E402
                                bn_scaled, rows)

TINY = dict(num_stack=1, hourglass_inch=16, num_cls=2, topk=8, conf_th=0.1,
            imsize=64)


def tiny(**kw):
    return Config(device="cpu", **{**TINY, **kw})


def images(n, seed=0, raw=False):
    rng = np.random.default_rng(seed)
    if raw:
        return rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    return rng.standard_normal((n, 64, 64, 3)).astype(np.float32)


def helmet_calls(path):
    """{op name: calls} of the `helmet` ops in a saved program's graph."""
    graph = torch.export.load(path).graph
    return Counter(str(n.target).split(".")[1] for n in graph.nodes
                   if str(n.target).startswith("helmet."))


def equal_rows(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("export"))
    cfg = tiny(save_path=out)
    program, package = export_predict(cfg)
    jax_out = str(tmp_path_factory.mktemp("jax_export"))
    jax_export_predict(JaxConfig(save_path=jax_out, **TINY), out_dir=jax_out)
    return cfg, out, program, package, jax_out


def test_export_writes_program_and_meta_with_jax_keys(exported):
    cfg, out, program, package, jax_out = exported
    assert program == os.path.join(out, PROGRAM) and package is None
    assert os.path.getsize(program) > 1000
    meta = json.load(open(os.path.join(out, "meta.json")))
    want = json.load(open(os.path.join(jax_out, "meta.json")))
    assert set(want) <= set(meta), set(want) - set(meta)
    for key, value in want.items():
        if key not in ("quant_scales_sha256", "quant_scales_path"):
            assert meta[key] == value, key
    assert meta["runner_package"] is None and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    from real_time_helmet_detection_tpu_torch.ops import _build
    assert meta["kernel_libraries"] == _build.kernel_digests()
    assert meta["op_library"] == _build.ops_digest()
    assert not os.path.exists(os.path.join(out, "serving"))
    assert meta["serve_buckets"] == [] and meta["serve_artifacts"] == {}


def test_load_exported_bit_equal_to_eager(exported):
    cfg, _, program, _, _ = exported
    x = images(1, seed=3)
    got = load_exported(program)(torch.from_numpy(x))
    want = make_predict_fn(load_eval_state(cfg), cfg, device="cpu")(x)
    assert equal_rows(got, want)


def test_graph_calls_the_helmet_ops_at_the_derived_sites(exported):
    cfg, _, program, _, _ = exported
    epi, tail = chip_smoke.bn_sites(cfg)
    assert helmet_calls(program) == Counter(
        peak_scores=1, bn_act=len(epi), bn_add_act=len(tail))


def test_exported_program_matches_jax_both_ways(tmp_path):
    jcfg = JaxConfig(conf_th=0.0, **{k: v for k, v in TINY.items()
                                      if k != "conf_th"})
    jmodel = jax_build(jcfg)
    params, stats = init_variables(jmodel, jax.random.key(5), 64)
    variables = bn_scaled(jax.device_get({"params": params,
                                          "batch_stats": stats}), 5)
    fn = jax_build_export_fn(jmodel, variables, jcfg, normalize="imagenet")
    from jax import export as jax_export
    spec = jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.uint8)
    bin_path = str(tmp_path / "exported_predict.bin")
    with open(bin_path, "wb") as f:
        f.write(jax_export.export(jax.jit(fn))(spec).serialize())
    x = images(2, seed=5, raw=True)
    want = jax.device_get(jax_load_exported(bin_path).call(jnp.asarray(x)))

    npz = str(tmp_path / "weights.npz")
    convert.save_npz(npz, variables)
    cfg = tiny(conf_th=0.0, model_load=npz, export_raw_input=True)
    program, _ = export_predict(cfg, out_dir=str(tmp_path / "port"),
                                batch_size=2)
    got = load_exported(program)(torch.from_numpy(x))
    n = assert_detections_match(rows(got), rows(want)) \
        + assert_detections_match(rows(want), rows(got))
    assert n > 0


def test_raw_input_program_takes_uint8_and_matches_float(tmp_path):
    raw_dir, norm_dir = str(tmp_path / "raw"), str(tmp_path / "norm")
    export_predict(tiny(conf_th=0.0, export_raw_input=True), out_dir=raw_dir)
    export_predict(tiny(conf_th=0.0), out_dir=norm_dir)
    meta = json.load(open(os.path.join(raw_dir, "meta.json")))
    assert meta["raw_input"] is True and meta["input_dtype"] == "uint8"
    graph = torch.export.load(os.path.join(raw_dir, PROGRAM))
    placeholder = next(n for n in graph.graph.nodes
                       if n.op == "placeholder" and n.name == "images")
    assert placeholder.meta["val"].dtype == torch.uint8
    raw = images(1, seed=7, raw=True)
    normed = np.stack([normalize_image(im, "imagenet") for im in raw])
    got = load_exported(os.path.join(raw_dir, PROGRAM))(torch.from_numpy(raw))
    want = load_exported(os.path.join(norm_dir, PROGRAM))(
        torch.from_numpy(normed))
    n = assert_detections_match(rows(got), rows(want)) \
        + assert_detections_match(rows(want), rows(got))
    assert n > 0


def test_export_serve_writes_the_jax_bucket_set(tmp_path):
    out = str(tmp_path)
    cfg = tiny(export_serve=True, serve_buckets=[2, 1])
    export_predict(cfg, out_dir=out)
    meta = json.load(open(os.path.join(out, "meta.json")))
    want = list(jax_resolve_buckets(JaxConfig(serve_buckets=[2, 1])))
    assert meta["serve_buckets"] == want == [1, 2]
    assert sorted(os.listdir(os.path.join(out, "serving"))) == ["b1", "b2"]
    assert meta["serve_artifacts"] == {"b1": "serving/b1",
                                       "b2": "serving/b2"}
    predict = make_predict_fn(load_eval_state(cfg), cfg, device="cpu")
    x = images(2, seed=9)
    for b in want:
        bdir = os.path.join(out, "serving", "b%d" % b)
        bmeta = json.load(open(os.path.join(bdir, "meta.json")))
        assert bmeta["serve_bucket"] == b
        assert bmeta["input_shape"] == [b, 64, 64, 3]
        got = load_exported(os.path.join(bdir, PROGRAM))(
            torch.from_numpy(x[:b]))
        assert equal_rows(got, predict(x[:b]))


def test_int8_export_sites_and_scales_hash(tmp_path):
    out = str(tmp_path)
    cfg = tiny(infer_dtype="int8", calib_batches=2)
    program, _ = export_predict(cfg, out_dir=out)
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["infer_dtype"] == "int8"
    path = os.path.join(out, meta["quant_scales_path"])
    assert meta["quant_scales_path"] == os.path.join("calibration",
                                                     "quant_scales.json")
    assert meta["quant_scales_sha256"] == scales_hash(jax_load_scales(path))
    dense, dw = chip_smoke.qconv_sites(cfg)
    # the program of the fused twin: the convs that write their
    # consumers' codes are the `*_codes` ops, the quantizer at two steps
    # `quantize_act2`
    quant, dual = chip_smoke.quant_walk(cfg)
    dense_codes, dw_codes = chip_smoke.code_walk(cfg)
    assert helmet_calls(program) == Counter({k: v for k, v in dict(
        peak_scores=1, quantize_act=quant - dual, quantize_act2=dual,
        qconv_dense=dense - dense_codes, qconv_dense_codes=dense_codes,
        qconv_dw=dw - dw_codes, qconv_dw_codes=dw_codes).items() if v})
    from real_time_helmet_detection_tpu_torch.ops import quant
    x = images(1, seed=11)
    want = make_predict_fn(load_eval_state(cfg), cfg, device="cpu",
                           quant_scales=quant.load_scales(path))(x)
    assert equal_rows(load_exported(program)(torch.from_numpy(x)), want)


def _op_cases():
    gen = torch.Generator().manual_seed(0)

    def cl(t):
        return t.contiguous(memory_format=torch.channels_last)

    def q8(shape):
        return cl(torch.randint(-127, 128, shape, generator=gen,
                                dtype=torch.int8))

    x = cl(torch.randn((2, 16, 3, 5), generator=gen))
    a, b = torch.rand(16, generator=gen) + 0.5, torch.randn(16, generator=gen)
    mult = torch.rand(8, generator=gen) * 1e-3
    plan = qconv.dense_plan(1, 5, 7, 16, 8, 3, 4)
    dw = qconv.dw_plan(1, 5, 7, 16)
    cases = {
        "peak_scores": (torch.randn((2, 1, 5, 8, 6), generator=gen), 2, 3,
                        2, "auto"),
        "bn_act": (x.to(torch.bfloat16), a, b, "ReLU", "auto"),
        "bn_add_act": (x, a, b, cl(torch.randn(x.shape, generator=gen)),
                       "Linear"),
        "quantize_act": (x * 3, torch.tensor(0.05)),
        "qconv_dense": (q8((1, 16, 5, 7)),
                        torch.randint(-127, 128, (8, 3, 3, 16), generator=gen,
                                      dtype=torch.int8),
                        mult, torch.randn(8, generator=gen), 0, "ReLU",
                        plan.variant, plan.box[1], plan.box[2], plan.n,
                        plan.stages),
        "qconv_dw": (q8((1, 16, 5, 7)),
                     torch.randint(-127, 128, (9, 16), generator=gen,
                                   dtype=torch.int8),
                     torch.rand(16, generator=gen) * 1e-2,
                     torch.randn(16, generator=gen), 1, "Linear",
                     dw.variant, *dw.tile, dw.ct),
    }
    # the code-writing forms (two code outputs, no float output / one
    # with it) and the quantizer at two steps
    cases["quantize_act2"] = cases["quantize_act"] + (torch.tensor(0.02),)
    s1, s2 = torch.tensor(0.05), torch.tensor(0.011)
    cases["qconv_dense_codes"] = cases["qconv_dense"] + (
        False, q8((1, 24, 5, 7)), s1, 16, q8((1, 8, 5, 7)), s2, 0)
    cases["qconv_dw_codes"] = cases["qconv_dw"] + (
        True, q8((1, 32, 5, 7)), s2, 8, None, None, 0)
    return cases


@pytest.mark.parametrize("name", sorted(library.SCHEMAS))
def test_opcheck(name):
    op = getattr(torch.ops.helmet, name).default
    torch.library.opcheck(op, _op_cases()[name])


def test_cpp_schemas_equal_the_python_ops():
    with open(os.path.join(REPO, "real_time_helmet_detection_tpu_torch",
                           "csrc", "torch_ops.cpp")) as f:
        text = f.read()
    cpp = ["".join(re.findall(r'"([^"]*)"', body))
           for body in re.findall(r"m\.def\((.*?)\);", text, re.S)]
    python = [str(getattr(torch.ops.helmet, name).default._schema)
              for name in library.SCHEMAS]
    assert ["helmet::" + s for s in cpp] == python
    assert cpp == list(library.SCHEMAS.values())


def test_default_device_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        export_predict(Config(**TINY), out_dir=str(tmp_path))
    assert not os.path.exists(os.path.join(tmp_path, PROGRAM))


def test_cli_export_writes_the_artifacts(tmp_path, capsys):
    main(["--export-flag", "--device", "cpu", "--imsize", "64",
          "--hourglass-inch", "16", "--topk", "8", "--save-path",
          str(tmp_path)])
    assert "exported:" in capsys.readouterr().out
    assert os.path.getsize(tmp_path / PROGRAM) > 1000
    meta = json.load(open(tmp_path / "meta.json"))
    assert meta["input_shape"] == [1, 64, 64, 3]
    assert meta["num_boxes"] == 8 and meta["runner_package"] is None
