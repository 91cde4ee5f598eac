"""The port's whole MTCNN cascade (``full_forward``, plain versions of the
kernels on the CPU, float32) against the JAX package's, on the same
converted parameters — cls biases shifted so that every stage has
candidates (as tests/test_models_mtcnn.py:776 does):

(a) the JAX parity mode (precision "highest", flax PNet module, gather
    crops) on 96x128 frames with the caps of tests/test_models_mtcnn.py:67;
(b) the JAX kernel path — ``pnet_stem="pallas-interpret"`` and
    ``crop_engine="pallas-interpret"``, chosen explicitly because on the CPU
    the JAX package would silently run its parity engines — on 63x97
    frames with the caps of tests/test_models_mtcnn.py:777.

Valid counts must agree exactly; boxes, scores and landmarks at the bounds
tests/test_models_mtcnn.py:84-86 hold the JAX cascade to against its torch
oracle (float32, different summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videotofaces_tpu.models import mtcnn as JM
from videotofaces_tpu_torch.models import mtcnn as TM

from test_torch_mtcnn_modules import jax_mtcnn_params

KEYS = ("stage1", "stage1_scale_max", "stage1_select_overflow", "cross_in",
        "stage2", "stage2_crop_dropped", "stage3", "stage3_crop_dropped")


def _compare(want, got):
    jb, js, jl, jv, jc = (jax.device_get(a) for a in want)
    tb, ts, tl, tv, tc = got
    assert set(tc) == set(KEYS) and set(jc) >= set(KEYS)
    for k in KEYS:
        assert tc[k].dtype == torch.int32 and tc[k].shape == (jv.shape[0],), k
    for k in ("stage1", "stage1_scale_max", "cross_in", "stage2", "stage3"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    tv = tv.numpy()
    np.testing.assert_array_equal(tv.sum(1), np.asarray(jv).sum(1))
    assert tv.sum() > 0, "no final detections — tune the test parameters"
    for i in range(tv.shape[0]):
        v, u = np.asarray(jv[i]), tv[i]
        np.testing.assert_allclose(ts[i].numpy()[u], js[i][v], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tb[i].numpy()[u], jb[i][v], rtol=1e-3, atol=2e-2)
        np.testing.assert_allclose(tl[i].numpy()[u], jl[i][v], rtol=1e-3, atol=2e-2)


@pytest.fixture(scope="module")
def params():
    return jax_mtcnn_params(seed=0, cls_shift=2.0)


def _port(params, frames, **kw):
    with torch.no_grad():
        return TM.full_forward(TM.MTCNN.from_jax(params), torch.from_numpy(frames), **kw)


def test_cascade_matches_jax_parity_mode(params):
    frames = np.random.default_rng(21).integers(0, 256, (2, 96, 128, 3)).astype(np.uint8)
    caps = dict(pre1=1024, post1=256, cross=1024, stage2=512, stage3=512, out=512)
    want = jax.jit(lambda p, f: JM.full_forward(p, f, minsize=20, caps=JM.Caps(**caps)))(
        params, jnp.asarray(frames))
    got = _port(params, frames, minsize=20, caps=TM.Caps(**caps))
    _compare(want, got)
    for k in ("stage1_select_overflow", "stage2_crop_dropped", "stage3_crop_dropped"):
        assert int(got[4][k].sum()) == 0


def test_cascade_matches_jax_kernel_path(params):
    frames = np.random.default_rng(22).integers(0, 256, (1, 63, 97, 3)).astype(np.uint8)
    caps = dict(pre1=32, post1=32, cross=64, stage2=48, stage3=24, out=16)
    want = jax.jit(lambda p, f: JM.full_forward(
        p, f, minsize=8, caps=JM.Caps(**caps), pnet_stem="pallas-interpret",
        crop_engine="pallas-interpret"))(params, jnp.asarray(frames))
    assert int(np.asarray(want[4]["stage2_crop_dropped"]).sum()) == 0
    assert int(np.asarray(want[4]["stage3_crop_dropped"]).sum()) == 0
    got = _port(params, frames, minsize=8, caps=TM.Caps(**caps))
    _compare(want, got)
    # the stacked stage-1 NMS is the same problem set in one batch
    stacked = _port(params, frames, minsize=8, caps=TM.Caps(**caps), stage1_nms="stacked")
    for a, b in zip(got[:4], stacked[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
