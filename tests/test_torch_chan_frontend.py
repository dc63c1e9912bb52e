"""The port's post-channelizer against the JAX package: the plain version
of kernel K6 (ops/chan_frontend.py) against ``ChanPostPipeline`` (the
Pallas ``_chan_kernel`` in interpret mode) on the same bins, and the
composed K5 → K6 plain path (``ChannelizedRxVFOBank.apply``) against the
fused V3 kernel (``_chan_fused_kernel_v3``) across a runtime retune and
against the chained XLA bank.  Float32 handoff.

Bounds: IF and state 80 dB against the kernels (measured ≥ 116 dB: the
NCO phase is formed op by op as the TPU kernel forms it, so only float32
sum order and cos/sin ulps differ), squelch sums rtol 1e-4, the NCO
phase bit-exact; 70 dB against the chained bank, whose NCO is a rotor
table and so rounds differently."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sdrplusplusbrown_tpu.models.rx_vfo import ChannelizedRxVFOBank as JaxBank
from sdrplusplusbrown_tpu.ops.chan_frontend import (
    ChanPostPipeline as JaxPost)
from sdrplusplusbrown_tpu_torch import convert
from sdrplusplusbrown_tpu_torch.models.rx_vfo import ChannelizedRxVFOBank
from sdrplusplusbrown_tpu_torch.ops import chan_frontend

from torch_parity import (FS, assert_state_close, nfm_iq, planes,
                          port_f32_handoff, snr_db)  # noqa: F401

M = 48


def _banks():
    return (JaxBank(FS, 50_000.0, 12_500.0),
            ChannelizedRxVFOBank(FS, 50_000.0, 12_500.0, device="cpu"))


def _offsets(C):
    """Both band edges (±1.1 MHz: bins 26 and 22) and both sides of DC
    (bins 47 and 0): negative offsets map to the high bins."""
    return np.concatenate([np.linspace(-1.1e6, 1.1e6, C - 2) + 917.0,
                           [-30e3, 10e3]])


def _if_close(jy, py, min_db):
    """IF agreement over the whole bank (a channel with no carrier sees
    float32 noise at the level of the band's loudest carrier, so its own
    ratio says little)."""
    jy, py = np.asarray(jy), py.numpy()
    assert jy.shape == py.shape
    assert snr_db(jy, py) >= min_db, snr_db(jy, py)


@pytest.mark.parametrize("C", [8, 16])
def test_post_matches_jax_kernel(C):
    jb, pb = _banks()
    _, post = pb.pipes()
    jpost = JaxPost(jb, C, interpret=True)
    assert (jpost.adv0, jpost.adv_f) == (post.adv0, post.adv_f)
    T = 48 * 2000
    Tb = 2 * T // M
    plan = post.plan(Tb)
    assert plan["Tb_pad"] == jpost._plan(Tb)["Tb_pad"]
    rng = np.random.default_rng(C)
    offs = _offsets(C)
    jparams = jb.make_params(offs)
    pparams = pb.make_params(offs)
    assert pparams["bin"].dtype == torch.int32
    np.testing.assert_array_equal(pparams["bin"].numpy(),
                                  np.asarray(jparams["bin"]))
    assert {int(b) for b in pparams["bin"]} >= {0, 22, 26, M - 1}
    js = jb.init_state(C)
    ps = convert.state_from_jax(js, device="cpu")
    for b in range(2):
        bins = rng.standard_normal((2 * M, plan["Tb_pad"])) \
            .astype(np.float32)
        jy, jsq, js = jpost.apply(jparams, js, jnp.asarray(bins), Tb=Tb)
        py, psq, ps = post.apply(pparams, ps, torch.from_numpy(bins), Tb)
        assert py.shape == (C, plan["m"][-1])
        _if_close(jy, py, 80.0)
        np.testing.assert_allclose(psq.numpy(), np.asarray(jsq), rtol=1e-4)
        np.testing.assert_allclose(
            psq.numpy(), np.abs(py.numpy()).sum(-1), rtol=1e-4)
        np.testing.assert_array_equal(ps["xl"].numpy(), np.asarray(js["xl"]))
        assert_state_close(js, ps, 80.0)
        (raw, m_if), _, _ = post.apply(pparams, convert.state_from_jax(
            js, device="cpu"), torch.from_numpy(bins), Tb, raw=True)
        assert raw.shape == (2 * C, plan["n_out"]) and m_if == Tb // 2


def test_composed_matches_jax_fused_v3_across_retune():
    C = 8
    jb, pb = _banks()
    T = 48 * 2000
    offs = _offsets(C)
    x = nfm_iq(2 * T, offs, range(0, C, 2), seed=7)
    js, ps = jb.init_state(C), pb.init_state(C)
    for b, o in enumerate((offs, offs + 13_100.0)):
        xb = x[b * T:(b + 1) * T]
        res = jb.apply_fused(jb.make_params(o), js, jnp.asarray(xb),
                             interpret=True)
        assert jb._chan_fused(C, True).use_v3
        jy, jsq, js = res
        py, psq, ps = pb.apply(pb.make_params(o), ps, planes(xb))
        _if_close(jy, py, 80.0)
        np.testing.assert_allclose(psq.numpy(), np.asarray(jsq), rtol=1e-4)
        assert_state_close(js, ps, 80.0)


def test_composed_matches_jax_chained_bank():
    C = 8
    jb, pb = _banks()
    T = 48 * 2000
    offs = _offsets(C)
    x = nfm_iq(2 * T, offs, range(1, C, 2), seed=8)
    js, ps = jb.init_state(C), pb.init_state(C)
    for b in range(2):
        xb = x[b * T:(b + 1) * T]
        jy, js = jb.apply(jb.make_params(offs), js, jnp.asarray(xb))
        py, _, ps = pb.apply(pb.make_params(offs), ps, planes(xb))
        _if_close(jy, py, 70.0)
    assert chan_frontend.chan_post_kernel.launches == 0
