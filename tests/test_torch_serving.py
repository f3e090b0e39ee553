"""The port's server (weatherconverter_tpu_torch/serving) against the JAX
package's, on the CPU with tiny models: the JAX serving tests
(tests/test_serving.py) ported, the server's helpers held bit for bit
against JAX's own, the per-row generators of the samplers, and the slice as
a whole: the service's batched chain, given the draws JAX made for each
request's key, against JAX's per-request chains.

Tolerances: the batched chains against JAX's per-item chains take
tests/test_torch_sampling.py's CHAIN_RTOL / CHAIN_ATOL (1e-4), with the same
fixed dither on both sides' seg input (the SRGAN output saturates at 1.0,
where max-pool ties break differently in XLA and ATen) and LCG's lam 0.02.
Everything else is exact: the helpers, a row against its batch-1 run, a
request's PNG solo and co-batched, and the 'auto' buckets against the full
sweep.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import jax_fns, load_strict, nhwc_to_nchw, perturb, seg_pair

from weatherconverter_tpu.core.config import UnetModelConfig as JUnetConfig
from weatherconverter_tpu.core.config import load_translation_config as j_load_translation_config
from weatherconverter_tpu.diffusion import schedule as JSch
from weatherconverter_tpu.guidance import translate as JT
from weatherconverter_tpu.models.srgan import Generator as JGenerator
from weatherconverter_tpu.models.unet import Unet as JUnet
from weatherconverter_tpu.serving import server as JS
from weatherconverter_tpu_torch.cli import commands as PC
from weatherconverter_tpu_torch.cli import main as PM
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.core.config import UnetModelConfig, load_translation_config
from weatherconverter_tpu_torch.diffusion import sampling as PSa
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.models.srgan import Generator
from weatherconverter_tpu_torch.models.unet import Unet
from weatherconverter_tpu_torch.serving import server as PSrv
from weatherconverter_tpu_torch.serving.batcher import MicroBatcher

# tests/test_serving.py's tiny config, on the port's seg model (DeepLabV3+) with the 19 train classes the labels hold
TINY_YAML = """
diffusion:
  model:
    im_size: 16
    down_channels: [8, 16, 24]
    mid_channels: [24, 24, 16]
    down_sample: [true, false]
    time_emb_dim: 16
    num_down_layers: 1
    num_mid_layers: 1
    num_up_layers: 1
    num_heads: 2
    attn_resolutions: [8]
  diffusion:
    num_timesteps: 20
seg:
  model: {name: deeplabv3plus_resnet18, num_classes: 19, output_stride: 16}
srgan: {in_channels: 3, num_channels: 8, num_blocks: 1, upscale_factor: 2}
guidance: {lambda: 10.0, num_steps: 3, mode: fixed}
"""
CHAIN_RTOL, CHAIN_ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this file's tiny models: more buy nothing here,
    and beside the suite's other parallel workers they oversubscribe the cores
    (a 2 s test of this file took 280 s that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve") / "t.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def _service(cfg_path, **kw):
    return PSrv.TranslationService(load_translation_config(cfg_path), device="cpu", **kw)


def _b64_png(arr_u8):
    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _inputs():
    rng = np.random.RandomState(0)
    return (_b64_png(rng.randint(0, 255, (40, 40, 3), dtype=np.uint8)),
            _b64_png(rng.randint(0, 34, (40, 40), dtype=np.uint8)))


# --- the batcher (tests/test_serving.py:19-55) ---

def test_microbatcher_groups_concurrent_requests_and_propagates_errors():
    calls = []

    def batch_fn(items):
        calls.append(len(items))
        return [a * 2 for (a,) in items]

    b = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=100.0)
    try:
        results = [None] * 6

        def worker(i):
            results[i] = b.submit(i)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == [i * 2 for i in range(6)] and sum(calls) == 6 and max(calls) >= 2
        assert b.stats["requests"] == 6
    finally:
        b.close()
    failing = MicroBatcher(lambda items: 1 / 0, max_batch=2, max_wait_ms=5.0)
    try:
        with pytest.raises(ZeroDivisionError):
            failing.submit(1)
    finally:
        failing.close()


# --- the helpers, bit for bit against JAX's own ---

def _jax_closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def test_server_helpers_equal_jax(cfg_path, monkeypatch):
    rng = np.random.RandomState(3)
    for shape, mode in (((40, 52, 3), None), ((30, 30), None), ((20, 20, 4), None), ((40, 40), "L")):
        arr = rng.randint(0, 255 if len(shape) == 3 else 34, shape, dtype=np.uint8)
        b64 = _b64_png(arr)
        for size, nearest in ((16, False), (32, True), (33, False)):
            assert np.array_equal(PSrv._decode_png(b64, size, nearest), JS._decode_png(b64, size, nearest))
    out = np.random.default_rng(4).uniform(-0.2, 1.2, (9, 7, 3)).astype(np.float32)
    assert PSrv._png_bytes(out) == JS._png_bytes(out)
    # the JAX service's nested helpers, taken from its translate batch function; its weights are not needed
    from weatherconverter_tpu.cli import commands as JC

    monkeypatch.setattr(JC, "_load_unet_params", lambda *a: None)
    monkeypatch.setattr(JC, "load_seg_variables", lambda *a: None)
    jcfg = j_load_translation_config(cfg_path)
    jsvc = JS.TranslationService(jcfg, batch=2, steps=3, max_wait_ms=5.0, lcg_present_k="auto", lcg_k_buckets=(2, 7))
    try:
        batch_fn = jsvc._translate_batcher._batch_fn
        j_n_present, j_bucket_for = _jax_closure(batch_fn, "_n_present"), _jax_closure(batch_fn, "_bucket_for")
        buckets = jsvc._k_buckets
    finally:
        jsvc.close()
    ours = _service(cfg_path, lcg_present_k="auto", lcg_k_buckets=(2, 7))
    ours.close()
    assert buckets == ours._k_buckets == (2, 7, 19)
    for gt in (np.full((8, 8), 255, np.uint8), np.arange(64).reshape(8, 8) % 25, np.zeros((4, 4), np.uint8)):
        assert PSrv._n_present(gt, 19) == j_n_present(gt)
    for n in range(1, 21):
        assert PSrv._bucket_for(n, buckets, 19) == j_bucket_for(n)


# --- per-row generators ---

def _eps(xt, t):
    return 0.3 * torch.tanh(xt) + 0.002 * t.reshape(-1, 1, 1, 1).float()


@pytest.mark.parametrize("sampler", ["ddpm", "ddim_eta1", "dpm"])
def test_per_row_generators_give_each_row_its_batch_1_draws(sampler):
    """Row i of a batched run under generators g_0..g_{B-1} equals a batch-1
    run under a generator seeded as g_i, exactly."""
    sched = PS.linear_schedule(20, 1e-3, 0.2)
    run = {"ddpm": lambda shape, g: PSa.ddpm_sample(_eps, sched, shape, g, num_steps=5),
           "ddim_eta1": lambda shape, g: PSa.ddim_sample(_eps, sched, shape, g, num_steps=5, eta=1.0),
           "dpm": lambda shape, g: PSa.dpm_solver_pp_2m_sample(_eps, sched, shape, g, num_steps=5)}[sampler]
    seeds = (7, 0, 123)
    batched = run((3, 6, 5, 3), [torch.Generator().manual_seed(s) for s in seeds])
    for i, s in enumerate(seeds):
        assert torch.equal(batched[i:i + 1], run((1, 6, 5, 3), torch.Generator().manual_seed(s)))
    with pytest.raises(ValueError, match="generators"):
        run((2, 6, 5, 3), [torch.Generator()])


@pytest.mark.parametrize("sampler", ["ddpm", "dpm"])
def test_per_row_generators_in_the_translations(cfg_path, sampler):
    """Through a guided chain of the tiny models (sample_with_sgg: a random
    start step and a draw a step, per row; the DPM chain): a row is exactly
    the same whatever image and seed share its batch, and within 1e-6 of its
    batch-1 run (at another batch width the CPU's convolutions add in
    another order: one f32 ulp of these outputs)."""
    svc = _service(cfg_path, sampler=sampler, steps=3)
    try:
        rng = np.random.default_rng(5)
        imgs = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
        gts = rng.integers(0, 19, (2, 32, 32))
        batched = svc.translate_rows(imgs, gts, [11, 12])
        for i, s in enumerate((11, 12)):
            solo = svc.translate_rows(imgs[i:i + 1], gts[i:i + 1], [s])
            assert (batched[i:i + 1] - solo).abs().max().item() <= 1e-6
        imgs[1], gts[1] = 0.3, 4
        assert torch.equal(svc.translate_rows(imgs, gts, [11, 99])[0], batched[0])
    finally:
        svc.close()


# --- the slice as a whole: the service's batched chain against JAX's per-request chains ---

LATENT, HR, STEPS = 16, 32, 3
SMALL_UNET = dict(im_size=16, down_channels=[8, 16, 24], mid_channels=[24, 24, 16], down_sample=[True, False],
                  time_emb_dim=16, num_down_layers=1, num_mid_layers=1, num_up_layers=1, num_heads=2,
                  attn_resolutions=[8])
PARITY_YAML = f"""
diffusion:
  model: {json.dumps(SMALL_UNET)}
  diffusion: {{num_timesteps: 20, beta_start: 0.001, beta_end: 0.2}}
seg:
  model: {{name: deeplabv3plus_resnet18, num_classes: 19, output_stride: 16}}
srgan: {{num_channels: 8, num_blocks: 1, upscale_factor: 2}}
guidance: {{lambda: 0.02, num_steps: 20, mode: fixed}}
"""


@pytest.fixture(scope="module")
def parity_models():
    """The tiny config's models at equal weights in both frameworks (the
    UNet's attention is plain softmax at N = 64; the flash path's parity is
    tests/test_torch_sampling.py's), and one fixed dither on both sides' seg
    input."""
    junet = JUnet(config=JUnetConfig(**SMALL_UNET), fused=True)
    uparams = perturb(jax.jit(junet.init)(jax.random.PRNGKey(0), jnp.zeros((1, LATENT, LATENT, 3)),
                                          jnp.zeros((1,), jnp.int32))["params"], 1)
    port_unet = load_strict(Unet(UnetModelConfig(**SMALL_UNET)), from_jax.unet_state_dict(uparams, UnetModelConfig(**SMALL_UNET)))
    jseg, seg_vars, port_seg = seg_pair("deeplabv3plus_resnet18", HR)
    jgen = JGenerator(num_channels=8, num_blocks=1, upscale_factor=2)
    gen_vars = jax.jit(jgen.init)(jax.random.PRNGKey(4), jnp.zeros((1, LATENT, LATENT, 3)))
    gen_vars = {"params": perturb(gen_vars["params"], 6), "batch_stats": perturb(gen_vars["batch_stats"], 7)}
    port_gen = load_strict(Generator(num_channels=8, num_blocks=1, upscale_factor=2),
                           from_jax.srgan_generator_state_dict(gen_vars, 1))
    diff_fn, seg_fn, sr_fn = jax_fns(junet, uparams, jseg, seg_vars, jgen, gen_vars)
    dither = (1e-2 * np.random.default_rng(HR).standard_normal((1, HR, HR, 3))).astype(np.float32)
    port_dither = nhwc_to_nchw(dither)
    port_seg.requires_grad_(False)
    return (diff_fn, lambda x: seg_fn(x + dither), sr_fn), (port_unet, lambda x: port_seg(x + port_dither), port_gen)


@pytest.mark.parametrize("sampler, present_k", [("ddim", 5), ("dpm", 3)])
def test_service_batched_chain_matches_jax_per_request_chains(tmp_path, parity_models, sampler, present_k):
    """The JAX server runs one chain per request under its own key (vmap);
    the port runs the micro-batch as one chain. Both at the same weights, the
    server's 'alternate' guidance (step 2 LCG, step 1 GSG, step 0 none), lam
    0.02, 3 steps over the 20-step span; the port replays each request's JAX
    draws through noise=."""
    (diff_fn, seg_fn, sr_fn), (port_unet, port_seg, port_gen) = parity_models
    (tmp_path / "p.yaml").write_text(PARITY_YAML)
    svc = PSrv.TranslationService(load_translation_config(str(tmp_path / "p.yaml")), batch=2, steps=STEPS,
                                  sampler=sampler, device="cpu")
    svc.unet, svc.seg, svc.sr = port_unet, port_seg, port_gen
    try:
        rng = np.random.default_rng(8)
        imgs = rng.uniform(-1, 1, (2, LATENT, LATENT, 3)).astype(np.float32)
        gts = rng.choice([0, 3, 8, 12, 17], (2, HR // 4, HR // 4)).repeat(4, 1).repeat(4, 2)
        seeds = (5, 9)
        sched = JSch.linear_schedule(20, 1e-3, 0.2)
        chain = JT.sample_with_sgg_dpm if sampler == "dpm" else JT.sample_with_sgg_ddim
        refs, inits = [], []
        for i, s in enumerate(seeds):
            key = jax.random.PRNGKey(s)
            refs.append(np.asarray(chain(diff_fn, sched, seg_fn, sr_fn, jnp.asarray(imgs[i:i + 1]),
                                         jnp.asarray(gts[i:i + 1]), key, lam=0.02, num_steps=STEPS, span_t=20,
                                         num_classes=19, mode="fixed", lcg_present_k=present_k))[0])
            inits.append(np.asarray(jax.random.normal(jax.random.split(key)[1], (1, LATENT, LATENT, 3))))
        noise0 = torch.from_numpy(np.concatenate(inits))
        noise = noise0 if sampler == "dpm" else (noise0, torch.zeros((STEPS, 2, LATENT, LATENT, 3)))
        out = svc.translate_rows(imgs, gts, present_k=present_k, noise=noise).numpy()
        assert out.shape == (2, HR, HR, 3)
        np.testing.assert_allclose(out, np.stack(refs), rtol=CHAIN_RTOL, atol=CHAIN_ATOL)
    finally:
        svc.close()


# --- the JAX serving tests, ported (tests/test_serving.py:80-316) ---

def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def _decoded(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_http_server_end_to_end(cfg_path):
    service = _service(cfg_path, batch=2, steps=3, max_wait_ms=10.0)
    httpd = PSrv.serve(service, port=0, block=False, host="127.0.0.1")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        img, lbl = _inputs()
        assert _decoded(_post(base, "/v1/translate", {"image": img, "label": lbl, "seed": 1})["image"]).shape == (32, 32, 3)
        assert _decoded(_post(base, "/v1/sample", {"steps": 3, "seed": 2})["image"]).shape == (16, 16, 3)
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["translate"]["requests"] == 1 and stats["sample"]["requests"] == 1
        for payload, code in (({"image": img}, 400), ({"image": "not a png", "label": lbl}, 500)):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(base, "/v1/translate", payload)
            assert err.value.code == code
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
    finally:
        httpd.shutdown()
        service.close()


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_http_server_fast_sampler_and_seed_determinism(cfg_path, sampler):
    """A seed returns the same PNG bytes solo and co-batched with another
    seed (per-row generators), and another seed another image."""
    service = _service(cfg_path, batch=2, steps=3, max_wait_ms=30.0, sampler=sampler)
    httpd = PSrv.serve(service, port=0, block=False, host="127.0.0.1")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        img, lbl = _inputs()
        first = _post(base, "/v1/translate", {"image": img, "label": lbl, "seed": 7})["image"]
        results = {}

        def worker(seed):
            results[seed] = _post(base, "/v1/translate", {"image": img, "label": lbl, "seed": seed})["image"]

        threads = [threading.Thread(target=worker, args=(s,)) for s in (7, 13)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results[7] == first, "the seed-7 image changed with co-batched traffic"
        assert results[13] != first
        assert service.stats()["translate"]["batches"] >= 1
    finally:
        httpd.shutdown()
        service.close()


def test_fast_sampler_defaults_and_reference_mode_refusal(cfg_path, monkeypatch):
    """--sampler ddim defaults translation to 50 steps and dpm to 20, and
    leaves /v1/sample at cfg.guidance.num_steps; mode 'reference' is refused
    for both (it would serve unguided images), accepted for ddpm."""
    for sampler, steps in (("ddim", 50), ("dpm", 20)):
        service = _service(cfg_path, batch=2, max_wait_ms=5.0, sampler=sampler)
        assert (service.steps, service.sample_steps) == (steps, 3)
        service.close()
    ref_cfg = load_translation_config(cfg_path)
    ref_cfg.guidance.mode = "reference"
    for sampler in ("ddim", "dpm"):
        with pytest.raises(ValueError, match="reference"):
            PSrv.TranslationService(ref_cfg, batch=2, sampler=sampler, device="cpu")
    PSrv.TranslationService(ref_cfg, batch=2, steps=3, device="cpu").close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the card by default, never a quiet CPU
        PSrv.TranslationService(load_translation_config(cfg_path), batch=2)


def test_bucketed_auto_k_bit_exact_and_routes_buckets(cfg_path):
    """'auto' routes each request to the smallest K bucket covering its
    label's classes, splits a mixed micro-batch into one chain per bucket,
    and gives every image byte for byte as the full-sweep service does."""
    img, _ = _inputs()
    plane2 = np.full((32, 32), 7, np.uint8)  # raw ids 7 -> train 0, 8 -> 1, 11 -> 2, 12 -> 3
    plane2[16:] = 8
    plane4 = np.full((32, 32), 7, np.uint8)
    plane4[8:16], plane4[16:24], plane4[24:] = 8, 11, 12
    lbl2, lbl4 = _b64_png(plane2), _b64_png(plane4)
    auto = _service(cfg_path, batch=2, steps=3, max_wait_ms=200.0, lcg_present_k="auto", lcg_k_buckets=(2,))
    full = _service(cfg_path, batch=2, steps=3, max_wait_ms=5.0)
    try:
        results = {}

        def worker(name, lbl, seed):
            results[name] = auto.translate(img, lbl, seed=seed)

        threads = [threading.Thread(target=worker, args=("two", lbl2, 7)),
                   threading.Thread(target=worker, args=("four", lbl4, 9))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert auto.bucket_counts == {2: 1, 19: 1}, auto.bucket_counts
        assert auto.stats()["lcg_k_buckets"] == {"2": 1, "19": 1}
        assert auto.shapes() == [(1, 2), (1, 19), (2, 2), (2, 19)]
        assert results["two"] == full.translate(img, lbl2, seed=7)
        assert results["four"] == full.translate(img, lbl4, seed=9)
    finally:
        auto.close()
        full.close()
    for bad in (0, "always"):
        with pytest.raises(ValueError, match="lcg_present_k"):
            _service(cfg_path, batch=2, lcg_present_k=bad)


# tests/test_torch_translate.py's tiny UNet (its 32x32 layers attend at N = 1024, D = 16: K2 takes them) in the
# translation config
FLASH_YAML = TINY_YAML.replace("im_size: 16", "im_size: 32").replace(
    "down_channels: [8, 16, 24]", "down_channels: [32, 32, 48]").replace(
    "mid_channels: [24, 24, 16]", "mid_channels: [48, 48, 32]").replace("attn_resolutions: [8]", "attn_resolutions: [32]")


def test_int8_service_keeps_a_request_independent_of_its_batch_mate(tmp_path):
    """With int8 on (the plain K2, one scale a request, as the JAX service's
    vmap takes it), a request's image is bit-equal whether its batch-mate is
    a faint image or a saturated one. With one scale for the micro-batch
    (the planted fault, the CLI's per-tensor mode), the same check fails."""
    from weatherconverter_tpu_torch.models.layers import SelfAttention2D

    (tmp_path / "t.yaml").write_text(FLASH_YAML)
    service = _service(str(tmp_path / "t.yaml"), batch=2, steps=2, qk_int8=True)
    try:
        assert service.qk_int8 and {k for _, _, k in service.unet.attention_kernels(32)} == {"K2", "softmax"}
        rng = np.random.default_rng(0)
        img = rng.uniform(-1, 1, (32, 32, 3))
        mates = (rng.uniform(-0.05, 0.05, (32, 32, 3)), np.sign(rng.standard_normal((32, 32, 3))))
        gts = rng.integers(0, 19, (2, 64, 64))

        def row0():
            return [service.translate_rows(np.stack([img, mate]), gts, seeds=[7, 8])[0] for mate in mates]

        a, b = row0()
        assert torch.equal(a, b)
        for m in service.unet.modules():
            if isinstance(m, SelfAttention2D):
                m.per_item = False
        a, b = row0()
        assert not torch.equal(a, b)
    finally:
        service.close()


def test_service_attention_choice(tmp_path):
    """K2 on the card by default, K1 with qk_int8=False (serve
    --no-int8-attn); the CPU runs K1's plain version unless asked for K2; the
    UNet takes one int8 scale a request either way (K2 in every layer, at
    every head dim the UNet has)."""
    from weatherconverter_tpu_torch.models.layers import SelfAttention2D

    (tmp_path / "t.yaml").write_text(FLASH_YAML)
    for kw, want in (({}, False), ({"qk_int8": True}, True), ({"qk_int8": False}, False)):
        service = _service(str(tmp_path / "t.yaml"), batch=2, **kw)
        layers = [m for m in service.unet.modules() if isinstance(m, SelfAttention2D)]
        assert service.qk_int8 == want and all(m.per_item for m in layers)
        assert [m.qk_int8 for m in layers] == [want for m in layers]
        service.close()
    args = PM.build_parser().parse_args(["serve", "--no-int8-attn", "--device", "cpu"])
    assert args.no_int8_attn and not PC.use_qk_int8(args, torch.device("cpu"))
    assert PC.use_qk_int8(PM.build_parser().parse_args(["serve"]), torch.device("cuda"))
