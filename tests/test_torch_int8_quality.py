"""The port's int8 quality check (probes/int8_quality.py) on the CPU, tiny,
against scripts/int8_quality_check.py's statistics transcribed in numpy: its
chains run the plain K1 and K2 through the tiny models of
tests/sampling_parity.py.
"""

import numpy as np
import pytest
import torch
from sampling_parity import B, HR, LAM, SCHED_ARGS, STEPS, build_models, translation_inputs

from weatherconverter_tpu_torch.diffusion import schedule as PS
from weatherconverter_tpu_torch.probes import int8_quality as IQ


@pytest.fixture(scope="module")
def models():
    return build_models()


def _numpy_statistics(outs, n_floor):
    """scripts/int8_quality_check.py:131-161, transcribed."""
    a, pa = outs["bf16"][0].numpy(), outs["bf16"][1].numpy()

    def against_bf16(name):
        b, pb = outs[name][0].numpy(), outs[name][1].numpy()
        return float(np.corrcoef(a.ravel(), b.ravel())[0, 1]), float((pa == pb).mean())

    corr_i8, agree_i8 = against_bf16("int8")
    floor = [against_bf16(f"bf16-pert{s}") for s in range(1, n_floor + 1)]
    floor_corr, floor_agree = np.asarray([c for c, _ in floor]), np.asarray([g for _, g in floor])
    cm, cs = float(floor_corr.mean()), float(floor_corr.std(ddof=1))
    gm, gs = float(floor_agree.mean()), float(floor_agree.std(ddof=1))
    ok = agree_i8 > 0.97 and corr_i8 >= cm - 2.0 * cs and agree_i8 >= gm - 2.0 * gs
    return corr_i8, agree_i8, (cm, cs), (gm, gs), ok


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_int8_quality_probe_statistics_and_verdict(models, sampler):
    x, gt = translation_inputs(9)
    port = models["port"]
    run_models = (port[0], models["port_unet_i8"], port[1], port[2])
    n_floor = 3
    # lam 60 drives every x0-pred of the tiny models to the clip at +-1, and all chains end alike
    artifact, outs = IQ.run(run_models, PS.linear_schedule(*SCHED_ARGS), torch.from_numpy(x),
                            torch.from_numpy(gt).long(), sampler, STEPS, n_floor, lam=LAM)
    assert set(outs) == {"bf16", "bf16-repeat", "int8", "bf16-pert1", "bf16-pert2", "bf16-pert3"}
    for out, pred, launches in outs.values():
        assert out.shape == (B, HR, HR, 3) and pred.shape == (B, HR, HR) and launches == (0, 0, 0)  # CPU: plain
    corr, agree, (cm, cs), (gm, gs), ok = _numpy_statistics(outs, n_floor)
    np.testing.assert_allclose(artifact["int8"]["pearson"], corr, rtol=0, atol=1e-9)
    assert artifact["int8"]["seg_agree"] == agree
    np.testing.assert_allclose([artifact["chaos_floor"]["pearson"]["mean"], artifact["chaos_floor"]["pearson"]["std"],
                                artifact["chaos_floor"]["seg_agree"]["mean"],
                                artifact["chaos_floor"]["seg_agree"]["std"]], [cm, cs, gm, gs], rtol=1e-9, atol=1e-12)
    assert artifact["pass"] == ok
    # the plain K2 path differs from K1 (int8 rounding), and an identical rerun does not
    assert artifact["int8"]["max_abs_diff"] > 0 and artifact["bf16_repeat"]["max_abs_diff"] == 0
    # the verdict rule itself, on made-up statistics
    fake = dict(outs, int8=(1.0 - outs["bf16"][0], outs["bf16"][1], (0, 0, 0)))  # anti-correlated
    assert IQ.statistics(fake, n_floor)["pass"] is False and _numpy_statistics(fake, n_floor)[-1] is False
