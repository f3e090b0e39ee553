"""The port's legacy UNet (models/unet_legacy.py), its conditioning
(ops/time_embed.alpha_plane_embedding), its sampler
(diffusion/sampling.ddpm_sample_legacy), its exporter and the reference
checkpoint's loader (compat/from_jax.py), and K1's plain version at the
legacy UNet's D = 24, against the JAX package on the CPU, in f32.

The JAX model's parameters are numpy draws on its eval_shape tree
(tests/torch_parity.seeded_leaves, then perturb): JAX's own init of this
model compiles for 14 s (38 s unjitted). Every residual branch's last conv
(and the output conv) is then scaled by 0.1 and the 1x1 residual convs by
0.7: at He scale the ~30 residual adds, normalized by running statistics
and not the batch's, grow the output to ~1e9, where a relative gate would
see nothing of the attention layers; damped, it is O(1). One jitted JAX
apply at 16 px, batch 1, serves the module. The sampler runs an analytic
eps-model on both sides with the JAX key stream replayed through `noise=`.

Tolerances: the UNet forward 1e-4 of max |ref| (f32 convolutions and
LayerNorms summed in other orders through ~40 layers); the embedding 5e-5
absolute (sin and cos of f32 arguments up to 2 pi * 1000: XLA's and ATen's
routines differ in the last bits there); the sampler 2e-5 (the samplers'
tolerance in tests/test_torch_sampling.py); K1's plain version that of
tests/test_torch_ops.py (rtol 1e-5, atol 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import perturb, seeded_leaves

from weatherconverter_tpu.compat.torch_export import export_legacy_unet as j_export_legacy_unet
from weatherconverter_tpu.compat.torch_import import convert_legacy_unet
from weatherconverter_tpu.diffusion import sampling as JSa
from weatherconverter_tpu.diffusion import schedule as JS
from weatherconverter_tpu.models import unet_legacy as JL
from weatherconverter_tpu.ops import attention as JA
from weatherconverter_tpu.ops.time_embed import alpha_plane_embedding as j_alpha_plane_embedding
from weatherconverter_tpu_torch.compat import from_jax
from weatherconverter_tpu_torch.diffusion import sampling as PSa
from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.models.unet_legacy import LN_EPS, LegacySelfAttention, LegacyUNet
from weatherconverter_tpu_torch.ops import attention as PA
from weatherconverter_tpu_torch.ops.time_embed import alpha_plane_embedding

SIZE = 16
UNET_REL_TOL = 1e-4
EMBED_ATOL = 5e-5
SAMPLER_RTOL, SAMPLER_ATOL = 2e-5, 2e-5


def _variables(module, *inputs, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))
    variables = seeded_leaves(shapes, seed)
    return {k: perturb(v, seed + 1) for k, v in variables.items()}


def _damped(params):
    def leaf(path, x):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] != "kernel":
            return x
        if "conv2" in names or "output" in names:
            return x * np.float32(0.1)
        return x * np.float32(0.7) if "res" in names else x

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def legacy_pair():
    """(JAX model, its variables, the jitted JAX apply, the port with the same weights)."""
    jm = JL.LegacyUNet(image_size=SIZE)
    variables = _variables(jm, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,)))
    variables["params"] = _damped(variables["params"])
    port = LegacyUNet(SIZE)
    port.load_state_dict(from_jax.legacy_unet_state_dict(variables), strict=True)
    return jm, variables, jax.jit(lambda x, t: jm.apply(variables, x, t)), port


def test_legacy_unet_matches_jax(legacy_pair):
    _, _, apply, port = legacy_pair
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([0.37], np.float32)
    ref = np.asarray(apply(x, t))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape and 0.1 < np.abs(ref).max() < 10
    assert np.abs(got - ref).max() / np.abs(ref).max() <= UNET_REL_TOL


def test_legacy_self_attention_takes_flax_layernorm_eps():
    """Tokens whose variance is 1e-6, where LayerNorm's eps shows: the port
    (eps 1e-6, flax's) matches JAX, and torch's default eps would not."""
    jm = JL.LegacySelfAttention(64)
    x = (1e-3 * np.random.default_rng(1).standard_normal((1, 4, 4, 64))).astype(np.float32)
    variables = _variables(jm, jnp.zeros((1, 4, 4, 64)), seed=3)
    ref = np.asarray(jax.jit(lambda x: jm.apply(variables, x))(x))
    params = variables["params"]
    sd = {"ln.weight": params["ln"]["scale"], "ln.bias": params["ln"]["bias"],
          "mha.in_proj_weight": params["qkv"]["kernel"].T, "mha.in_proj_bias": params["qkv"]["bias"],
          "mha.out_proj.weight": params["out"]["kernel"].T, "mha.out_proj.bias": params["out"]["bias"],
          "ff_self.0.weight": params["ff_ln"]["scale"], "ff_self.0.bias": params["ff_ln"]["bias"],
          "ff_self.1.weight": params["ff1"]["kernel"].T, "ff_self.1.bias": params["ff1"]["bias"],
          "ff_self.3.weight": params["ff2"]["kernel"].T, "ff_self.3.bias": params["ff2"]["bias"]}
    port = LegacySelfAttention(64)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 1).numpy()
        assert port.ln.eps == LN_EPS == 1e-6
        port.ln.eps = port.ff_self[0].eps = 1e-5
        torch_default = port(xt).permute(0, 2, 3, 1).numpy()
    scale = np.abs(ref - x).max()  # what the block adds to its input
    assert np.abs(got - ref).max() <= 1e-4 * scale
    assert np.abs(torch_default - ref).max() >= 1e-2 * scale


def test_alpha_plane_embedding_matches_jax():
    v = np.concatenate([[0.0, 1.0], np.random.default_rng(2).uniform(0, 1, 6)]).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: j_alpha_plane_embedding(v, 5, 32))(v))
    got = alpha_plane_embedding(torch.from_numpy(v), 5, 32)
    assert got.shape == (8, 5, 5, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=EMBED_ATOL)
    assert torch.equal(alpha_plane_embedding(torch.from_numpy(v).reshape(8, 1, 1, 1), 5, 32), got)


def analytic_eps(xt, cond):
    """A nonlinear eps-model of x_t and the legacy conditioning, elementwise, in either framework."""
    lib = jnp if isinstance(xt, jax.Array) else torch
    c = cond.reshape(-1, 1, 1, 1)
    return 0.3 * lib.tanh(xt) + 0.05 * c


@pytest.mark.parametrize("steps", [None, 5], ids=["full", "strided"])
def test_ddpm_sample_legacy_matches_jax(steps):
    """At S = T the beta-variance step; strided, the subsequence posterior;
    the conditioning 1 - alpha_bar[t]; the draws replayed in the JAX split
    order (init, then one z a step)."""
    shape, T = (2, 4, 4, 3), 20
    key = jax.random.PRNGKey(3)
    jsched, psched = JS.linear_schedule(T, 1e-3, 0.2), PS.linear_schedule(T, 1e-3, 0.2)
    ref = np.asarray(JSa.ddpm_sample_legacy(analytic_eps, jsched, key, shape, num_steps=steps))
    n_steps = steps or T
    key, ikey = jax.random.split(key)
    x_init = np.array(jax.random.normal(ikey, shape))
    zs = []
    for _ in range(n_steps):
        key, zkey = jax.random.split(key)
        zs.append(np.array(jax.random.normal(zkey, shape)))
    conds = []

    def eps(xt, cond):
        conds.append(cond.clone())
        return analytic_eps(xt, cond)

    got = PSa.ddpm_sample_legacy(eps, psched, shape, num_steps=steps,
                                 noise=(torch.from_numpy(x_init), torch.from_numpy(np.stack(zs))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=SAMPLER_RTOL, atol=SAMPLER_ATOL)
    taus = PSa.strided_taus(T, steps)[0] if steps else list(range(T - 1, -1, -1))
    assert [c.shape for c in conds] == [(2,)] * n_steps
    assert all(torch.equal(c, psched.one_minus_cum_prod[t].expand(2)) for c, t in zip(conds, taus))


def test_k1_plain_at_head_dim_24_matches_jax_flash_attention():
    """The legacy UNet's attn_up2 shape, one head: the port's K1 plain version
    against JAX's flash_attention (Pallas in interpret mode)."""
    rng = np.random.default_rng(24)
    q, k, v = (rng.standard_normal((1, 1, 1024, 24)).astype(np.float32) for _ in range(3))
    ref = np.asarray(JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = PA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-6)


def test_export_legacy_unet_is_bit_equal_to_jax_and_loads_strict(legacy_pair):
    _, variables, _, port = legacy_pair
    ours = from_jax.export_legacy_unet(variables["params"], variables["batch_stats"])
    theirs = j_export_legacy_unet(variables["params"], variables["batch_stats"])
    assert list(ours) == list(theirs)
    for name in theirs:
        a, b = np.asarray(ours[name]), np.asarray(theirs[name])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert set(ours) == set(port.state_dict())
    LegacyUNet(SIZE).load_state_dict(from_jax.to_torch_state_dict(ours), strict=True)


def test_reference_checkpoint_loader_drops_exactly_the_dead_keys(legacy_pair):
    """A reference file holds `res.weight` on the non-residual down blocks,
    which its model never applies: the loader drops those, loads the rest
    with strict=True (what JAX's converter reads, key for key), and any
    other extra or missing key raises."""
    _, variables, _, port = legacy_pair
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    dead = from_jax.dead_legacy_keys()
    assert len(dead) == 8 and not set(dead) & set(sd)
    for name in dead:
        n = int(name[4])
        width = (32, 64, 96, 128)[n - 1]
        sd[name] = torch.zeros(width, width, 1, 1)
    params, _ = convert_legacy_unet({k: v.numpy() for k, v in sd.items()})
    assert jax.tree_util.tree_all(jax.tree.map(lambda a, b: np.array_equal(a, b), params, variables["params"]))
    fresh = from_jax.load_legacy_reference(LegacyUNet(SIZE), sd)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in port.state_dict().items())
    with pytest.raises(RuntimeError, match="Unexpected key"):
        from_jax.load_legacy_reference(LegacyUNet(SIZE), {**sd, "up1.residual_blocks.9.res.weight": torch.zeros(1)})
    missing = dict(sd)
    missing.pop("attn_up2.ln.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        from_jax.load_legacy_reference(LegacyUNet(SIZE), missing)


def test_legacy_unet_takes_k2_only_at_head_dim_16_and_refuses_f32_on_cuda_by_name():
    """At 128 px, attn_down3 (1024, 16) and attn_up2 (1024, 24) reach the
    flash kernels: with qk_int8 both take K2 (K3 lacks D = 24, which only the
    sampling legacy UNet has); the others run plain softmax. An f32
    model is refused on CUDA at the entry, by name (checked without a card)."""
    with torch.device("meta"):
        model = LegacyUNet(128, qk_int8=True)
    assert model.attention_kernels(128) == [(1024, 16, "K2"), (256, 24, "softmax"), (64, 64, "softmax"),
                                            (256, 32, "softmax"), (1024, 24, "K2")]
    assert [k for _, _, k in LegacyUNet(16).attention_kernels(128)] == ["K1", "softmax", "softmax", "softmax", "K1"]
    with pytest.raises(ValueError, match=r"LegacyUNet.forward: .*\(1024, 16\), \(1024, 24\)"):
        PA.check_flash_precision("cuda", torch.float32, model.attention_shapes(128), "LegacyUNet.forward")
    assert 24 in PA.KERNEL_HEAD_DIMS and 24 not in PA.BWD_HEAD_DIMS and 24 in PA.QK_I8_HEAD_DIMS
    with pytest.raises(ValueError, match="flash_attention_bwd: head dim 24"):
        PA._check_bwd_head_dim(24)
    assert not model.training


def test_legacy_precision_probe_runs_tiny_on_the_cpu():
    """probes/legacy_precision at 16 px, 3 strided steps, a 2-run floor: the
    f32 "device" chain on the CPU is the f32 chain itself (Pearson 1, a
    pass), the bf16 one (CPU autocast) and the perturbed ones move the
    output, and the launch check reads each run's per-layer kernels (here
    faked: K1-f32 twice a forward)."""
    from weatherconverter_tpu_torch.probes import legacy_precision as LP

    artifact = LP.run(LP.build(image_size=16), (1, 16, 16, 3), 3, 2, torch.device("cpu"))
    f32, bf16 = artifact["runs"]["f32"], artifact["runs"]["bf16"]
    assert f32["pearson"] == pytest.approx(1.0, abs=1e-12) and f32["passes"] and f32["max_abs_diff"] == 0.0
    assert bf16["max_abs_diff"] > 0.0 and bf16["pearson"] < 1.0
    floor = artifact["chaos_floor"]
    assert len(floor["values"]) == 2 and all(v < 1.0 for v in floor["values"])
    assert f32["kernels"] == [(16, 16, "softmax"), (4, 24, "softmax"), (1, 64, "softmax"), (4, 32, "softmax"),
                              (16, 24, "softmax")]
    faked = dict(artifact, runs={"f32": dict(f32, kernels=[(1024, 16, "K1"), (1024, 24, "K1")],
                                             launches=[0, 0, 0, 6])})
    LP.check_launches(faked)
    faked["runs"]["f32"]["launches"] = [6, 0, 0, 0]
    with pytest.raises(AssertionError, match="K1-f32"):
        LP.check_launches(faked)
