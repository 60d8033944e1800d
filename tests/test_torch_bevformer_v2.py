"""The port's BEVFormerV2 family against the JAX package's, on the CPU in
f32: ``ResNetFusion``, ``BEVFormerV2`` (eval forward, ``loss`` with and
without the mono hook, ``get_bboxes``, the parameter gradients of one
train forward and loss), ``GroupMultiheadAttention`` in eval and grouped
train mode, ``Anchor3DHead`` with both assigners and ``BEVHead``, and the
builder.

The model is tests/models/test_v2_stack.py's (embed 32, BEV 8x8, 3
cameras at 64x64, 16 queries, R50, frames (-1, 0), one fusion block, one
encoder layer); numpy-seeded weights carried with ``state_dict_from_jax``.
One module-scoped fixture holds the JAX side: one ``eval_shape`` trace
and two jitted functions.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from vidar_tpu.data import make_synthetic_batch as jax_synthetic_batch
from vidar_tpu.models.attention import \
    GroupMultiheadAttention as JaxGroupMHA
from vidar_tpu.models.bev_head import Anchor3DHead as JaxAnchor3DHead
from vidar_tpu.models.bev_head import BEVHead as JaxBEVHead
from vidar_tpu.models.bevformer_v2 import BEVFormerV2 as JaxBEVFormerV2
from vidar_tpu.models.bevformer_v2 import ResNetFusion as JaxResNetFusion

from vidar_tpu_torch.convert import state_dict_from_jax
from vidar_tpu_torch.core.builder import NOT_PORTED, build_model
from vidar_tpu_torch.data import make_synthetic_batch
from vidar_tpu_torch.models import BEVFormerV2
from vidar_tpu_torch.models.attention import GroupMultiheadAttention
from vidar_tpu_torch.models.bev_head import Anchor3DHead, BEVHead
from vidar_tpu_torch.models.bevformer_v2 import ResNetFusion

# tests/models/test_v2_stack.py:42-55
V2 = dict(embed_dims=32, bev_h=8, bev_w=8, num_cams=3, num_query=16,
          backbone_depth=50, backbone_dcn=(False, False, False, False),
          frames=(-1, 0), num_fusion=1, encoder_num_layers=1)
BATCH = dict(bs=1, queue_length=2, future_length=0, num_cams=3, img_h=64,
             img_w=64, max_points=64)
# a module alone: f32 sums in other orders
MODULE_TOL = 1e-4
# the whole model: ~60 layers of f32 in other orders, forward and back, as
# tests/test_torch_bevformer.py
MODEL_TOL = 1e-3


def _random_params(shapes, seed=0):
    """Numpy-seeded weights with unit-scale activations: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.1), anything
    else N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            v = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == 'bias':
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            v = rng.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, what, tol=MODULE_TOL):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (
        what, err, np.abs(want).max())


def _gt(rng, bs, g, extent):
    """Random GT boxes [bs, g, 9] (cx cy cz w l h yaw vx vy) inside
    +-extent metres, random labels of 4 classes."""
    boxes = np.concatenate([
        rng.uniform(-extent, extent, (bs, g, 2)),
        rng.uniform(-1.0, 1.0, (bs, g, 1)),
        rng.uniform(1.0, 4.0, (bs, g, 3)),
        rng.uniform(-3.0, 3.0, (bs, g, 1)),
        rng.uniform(-1.0, 1.0, (bs, g, 2))], -1).astype(np.float32)
    labels = rng.integers(0, 4, (bs, g)).astype(np.int32)
    return boxes, labels


@pytest.fixture(scope='module')
def v2():
    jbatch = jax_synthetic_batch(np.random.default_rng(0), **BATCH)
    jmodel = JaxBEVFormerV2(**V2)
    key = jax.random.PRNGKey(0)
    params = _random_params(jax.eval_shape(lambda: jmodel.init(
        {'params': key, 'dropout': key}, jbatch, train=False)))
    gt, labels = _gt(np.random.default_rng(1), 1, 4, 40.0)
    nv = np.array([3], np.int32)

    @jax.jit
    def evaluate(p):
        preds = jmodel.apply(p, jbatch, train=False)
        losses = jmodel.apply(p, preds, gt, labels, nv,
                              dict(loss_fcos=jnp.float32(2.0)),
                              method=jmodel.loss)
        return preds, jmodel.apply(p, preds, method=jmodel.get_bboxes), \
            losses

    def loss_fn(p):
        preds = jmodel.apply(p, jbatch, train=True)
        losses = jmodel.apply(p, preds, gt, labels, nv, method=jmodel.loss)
        return sum(jax.tree.leaves(losses)), losses

    jpreds, jdet, jlosses = evaluate(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, '__call__', lambda self, x, **kw: x)
        (_, jtrain_losses), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)

    model = BEVFormerV2(**V2, device='cpu')
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()                                   # dropout off
    tbatch = make_synthetic_batch(np.random.default_rng(0), **BATCH,
                                  device='cpu')
    tgt = tuple(map(torch.from_numpy, (gt, labels, nv)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.inference_mode():
            tpreds = model(tbatch, train=False)
            tdet = model.get_bboxes(tpreds)
            tlosses = model.loss(tpreds, *tgt,
                                 dict(loss_fcos=torch.tensor(2.0)))
        train_losses = model.loss(model(tbatch, train=True), *tgt)
        sum(train_losses.values()).backward()
    finally:
        torch.set_num_threads(threads)
    return dict(params=params, jbatch=jbatch, tbatch=tbatch, jpreds=jpreds,
                jdet=jdet, jlosses=jlosses, jtrain_losses=jtrain_losses,
                jgrads=jgrads, model=model, tpreds=tpreds, tdet=tdet,
                tlosses=tlosses, train_losses=train_losses)


def test_batch_and_weights_carry_over(v2):
    for name in ('images', 'lidar2img', 'can_bus'):
        np.testing.assert_array_equal(getattr(v2['tbatch'], name).numpy(),
                                      np.asarray(getattr(v2['jbatch'], name)))
    sd = state_dict_from_jax(v2['params'])
    assert len(sd) == len(jax.tree_util.tree_leaves(v2['params']))
    assert set(sd) == set(v2['model'].state_dict())
    assert sd['fusion.layer0.norm1.weight'].shape == (64,)


@pytest.mark.parametrize('key', ['all_cls_scores', 'all_bbox_preds'])
def test_eval_forward_matches_jax(v2, key):
    _close(v2['tpreds'][key], v2['jpreds'][key], key, MODEL_TOL)


def test_get_bboxes_matches_jax(v2):
    got, want = v2['tdet'], v2['jdet']
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    _close(got['scores'], want['scores'], 'scores', MODEL_TOL)
    _close(got['bboxes'], want['bboxes'], 'bboxes', MODEL_TOL)


def test_loss_and_mono_hook_match_jax(v2):
    got, want = v2['tlosses'], v2['jlosses']
    assert set(got) == set(want) and 'loss_fcos_mono' in got
    assert float(got['loss_fcos_mono']) == pytest.approx(2.0)
    for k in sorted(want):
        _close(got[k], want[k], k, MODEL_TOL)


def test_train_losses_and_grads_match_jax(v2):
    for k in sorted(v2['jtrain_losses']):
        _close(v2['train_losses'][k], v2['jtrain_losses'][k], k, MODEL_TOL)
    want = state_dict_from_jax(v2['jgrads'])
    checked, zero = 0, 0
    for name, p in v2['model'].named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        ref = want[name].numpy()
        if name.endswith('self_attn.key.bias'):
            # zero in exact arithmetic (the softmax ignores a shift shared
            # by all keys): rounding noise on both sides
            floor = 1e-5 * np.abs(want[name.replace('key', 'query')]
                                  .numpy()).max()
            assert np.abs(ref).max() <= floor and float(
                got.abs().max()) <= floor, name
            continue
        if not np.abs(ref).max() > 0:
            assert float(got.abs().max()) == 0, name
            zero += 1
            continue
        _close(got, ref, name, MODEL_TOL)
        checked += 1
    assert checked > 150 and zero > 0, (checked, zero)
    # the frozen stem's gradient is cut; the fusion and the encoder train
    model = v2['model']
    assert model.img_backbone.conv1.weight.grad is None
    assert float(model.fusion.layer0.conv1.weight.grad.abs().max()) > 0


def test_history_frame_is_encoded_without_gradient(v2):
    """frames (-1, 0): the history frame's BEV carries no graph (JAX's
    stop_gradient), the current frame's does."""
    model = v2['model']
    captured = []
    hook = model.pts_bbox_head_bev.register_forward_hook(
        lambda m, a, out: captured.append(out))
    try:
        model(v2['tbatch'], train=True)
    finally:
        hook.remove()
    assert [b.requires_grad for b in captured] == [False, True]


def test_resnet_fusion_matches_jax():
    rng = np.random.default_rng(2)
    maps = [rng.standard_normal((1, 8, 6, 16)).astype(np.float32)
            for _ in range(3)]
    jmod = JaxResNetFusion(out_channels=16, inter_channels=48, num_layer=2)
    params = _random_params(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), maps)), seed=3)
    want = jax.jit(jmod.apply)(params, maps)
    mod = ResNetFusion(48, 16, 48, num_layer=2)
    mod.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = mod([torch.from_numpy(m) for m in maps])
    assert got.shape == (1, 48, 16)
    _close(got, want, 'ResNetFusion')


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'grouped'])
def test_group_multihead_attention_matches_flax(train):
    rng = np.random.default_rng(4)
    q, pos = (rng.standard_normal((2, 12, 16)).astype(np.float32)
              for _ in range(2))
    jmod = JaxGroupMHA(embed_dims=16, num_heads=2, group=3)
    params = _random_params(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), q, query_pos=pos)), seed=5)
    want = jmod.apply(params, q, query_pos=pos, deterministic=not train,
                      rngs={'dropout': jax.random.PRNGKey(1)})
    mod = GroupMultiheadAttention(embed_dims=16, num_heads=2, group=3)
    mod.load_state_dict(state_dict_from_jax(params), strict=True)
    mod.train(train)
    with torch.no_grad():
        got = mod(torch.from_numpy(q), query_pos=torch.from_numpy(pos))
    _close(got, want, f'GroupMultiheadAttention train={train}')
    if train:   # the groups attend within themselves only
        mod.eval()
        with torch.no_grad():
            full = mod(torch.from_numpy(q), query_pos=torch.from_numpy(pos))
        assert not np.allclose(full.numpy(), got.numpy())


@pytest.mark.parametrize('assigner', ['free_anchor', 'nearest'])
def test_anchor3d_head_matches_jax(assigner):
    rng = np.random.default_rng(6)
    bev = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    gt, labels = _gt(rng, 2, 5, 7.0)
    nv = np.array([3, 0], np.int32)
    kw = dict(num_classes=4, embed_dims=16, pc_range=(-8, -8, -5, 8, 8, 3),
              assigner=assigner)
    jhead = JaxAnchor3DHead(**kw)
    params = _random_params(jax.eval_shape(
        lambda: jhead.init(jax.random.PRNGKey(0), bev)), seed=7)

    @jax.jit
    def run(p):
        def loss(p):
            ls = jhead.apply(p, jhead.apply(p, bev), gt, labels, nv,
                             method=jhead.loss)
            return sum(jax.tree.leaves(ls)), ls
        (_, ls), g = jax.value_and_grad(loss, has_aux=True)(p)
        det = jhead.apply(p, jhead.apply(p, bev), method=jhead.get_bboxes)
        return ls, g, det

    jlosses, jgrads, jdet = run(params)
    head = Anchor3DHead(**kw)
    head.load_state_dict(state_dict_from_jax(params), strict=True)
    preds = head(torch.from_numpy(bev))
    assert preds[0].shape == (2, 8 * 8 * head.num_anchors, 4)
    losses = head.loss(preds, *map(torch.from_numpy, (gt, labels, nv)))
    assert set(losses) == set(jlosses)
    for k in jlosses:
        _close(losses[k], jlosses[k], k)
    sum(losses.values()).backward()
    want = state_dict_from_jax(jgrads)
    for name, p in head.named_parameters():
        _close(p.grad, want[name], f'd {name}')
    with torch.no_grad():
        det = head.get_bboxes(head(torch.from_numpy(bev)))
    np.testing.assert_array_equal(det['labels'].numpy(),
                                  np.asarray(jdet['labels']))
    _close(det['scores'], jdet['scores'], 'scores')
    _close(det['bboxes'], jdet['bboxes'], 'bboxes')


def test_bev_head_matches_jax():
    rng = np.random.default_rng(8)
    batch = jax_synthetic_batch(rng, **BATCH)
    feats = [rng.standard_normal((1, 3, s, s, 32)).astype(np.float32)
             for s in (8, 4, 2, 1)]
    can_bus = np.array(batch.can_bus[:, -1])
    l2i = np.array(batch.lidar2img[:, -1])
    kw = dict(embed_dims=32, bev_h=8, bev_w=8, num_cams=3, num_classes=4,
              encoder_num_layers=1, pc_range=(-8, -8, -5, 8, 8, 3))
    jhead = JaxBEVHead(**kw)
    params = _random_params(jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), feats, can_bus, l2i, (64, 64))), seed=9)
    gt, labels = _gt(rng, 1, 4, 7.0)
    nv = np.array([4], np.int32)

    @jax.jit
    def run(p):
        ret = jhead.apply(p, feats, can_bus, l2i, (64, 64))
        return (ret, jhead.apply(p, ret, gt, labels, nv, method=jhead.loss),
                jhead.apply(p, ret, method=jhead.get_bboxes))

    jret, jlosses, jdet = run(params)
    head = BEVHead(**kw)
    head.load_state_dict(state_dict_from_jax(params), strict=True)
    head.eval()
    with torch.no_grad():
        ret = head([torch.from_numpy(f) for f in feats],
                   torch.from_numpy(can_bus), torch.from_numpy(l2i),
                   (64, 64))
        losses = head.loss(ret, *map(torch.from_numpy, (gt, labels, nv)))
        det = head.get_bboxes(ret)
    _close(ret['bev_embed'], jret['bev_embed'], 'BEV', MODEL_TOL)
    for i, name in enumerate(('cls', 'reg', 'dir')):
        _close(ret['pred'][i], jret['pred'][i], name, MODEL_TOL)
    for k in jlosses:
        _close(losses[k], jlosses[k], k, MODEL_TOL)
    _close(det['scores'], jdet['scores'], 'scores', MODEL_TOL)


def test_builder_builds_bevformer_v2(v2):
    assert NOT_PORTED == ()
    model = build_model(dict(type='BEVFormerV2', **V2), device='cpu')
    assert isinstance(model, BEVFormerV2)
    assert {k: tuple(v.shape) for k, v in state_dict_from_jax(
        v2['params']).items()} == {k: tuple(v.shape) for k, v in
                                   model.state_dict().items()}
