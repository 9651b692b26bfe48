"""Parity of the port's train step against the JAX package, on CPU, float32.

The small fusion coop detector (configs/presets.py `SMALL_FUSION_*`, 2 DN
groups) on `small_fusion_train_batch()` (4 GT slots, 3 valid), in train
mode with dropout 0, the grid mask off and DN `noise_scale` 0 (the DN
queries are then a function of the GT alone), its flax variables perturbed
and carried across by `from_jax_variables`. Held against `model.apply(...,
mutable=["batch_stats"])` + `cmt_loss` and `jax.grad` of the same loss:

- the loss dict (every `d{i}.`, `dn_` and total term), rtol 1e-4, atol 1e-5;
- the gradient of every parameter, carried across by `from_jax_variables`
  (the map is linear), each to 2e-3 of its own max |JAX grad| plus 1e-6
  (float32 through ~40 layers, the Hungarian matching identical; the 1e-6
  covers the first layer's self-attention, whose value input is the
  all-zero target, so its gradients are ~1e-8);
- the updated batch statistics, rtol = atol = 1e-4;
- three AdamW steps of the port's optimizer against the optax chain of
  `make_optimizer` on the same gradients and parameters, rtol 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cmtcoop_tpu.configs.presets import tiny_preset as jtiny_preset
from cmtcoop_tpu.models.build import build_detector as jbuild
from cmtcoop_tpu.models.cmt_loss import cmt_loss as jcmt_loss
from cmtcoop_tpu.train.optim import make_optimizer
from cmtcoop_tpu_torch.configs.presets import (SMALL_FUSION_EXTRACTOR,
                                               SMALL_FUSION_HEAD,
                                               SMALL_FUSION_PRESET,
                                               tiny_preset)
from cmtcoop_tpu_torch.convert import from_jax_variables
from cmtcoop_tpu_torch.data.synthetic import small_fusion_train_batch
from cmtcoop_tpu_torch.models.build import build_detector
from cmtcoop_tpu_torch.models.cmt_loss import cmt_loss
from cmtcoop_tpu_torch.train.optim import AdamW
from cmtcoop_tpu_torch.train.train_step import step_generators
from tests.test_torch_camera import _perturbed

EXTRACTOR = dict(SMALL_FUSION_EXTRACTOR, use_grid_mask=False)
HEAD = dict(SMALL_FUSION_HEAD, max_gt=4, dropout=0.0, noise_scale=0.0)
GRAD_TOL = 2e-3


def port_model(variables):
    model = build_detector(tiny_preset(**SMALL_FUSION_PRESET), train=True,
                           extractor_kwargs=EXTRACTOR, head_kwargs=HEAD)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def jax_step():
    preset = jtiny_preset(**SMALL_FUSION_PRESET)
    model = jbuild(preset, train=True, extractor_kwargs=EXTRACTOR,
                   head_kwargs=HEAD)
    batch = small_fusion_train_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = {n: jax.random.PRNGKey(i) for i, n in enumerate(
        ("params", "dn", "dropout", "gridmask"))}
    variables = jax.tree.map(np.asarray, _perturbed(
        jax.jit(model.init)(keys, jb), np.random.default_rng(0)))

    def loss_fn(params):
        (outs, dn_info), mutated = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            mutable=["batch_stats"], rngs=keys)
        losses = jcmt_loss(outs, dn_info, jb["gt_boxes"], jb["gt_labels"],
                           jb["gt_mask"], tasks=preset.tasks)
        return losses["loss"], (losses, mutated["batch_stats"])

    grads, (losses, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"])
    return dict(batch=batch, variables=variables, tasks=preset.tasks,
                losses={k: float(v) for k, v in losses.items()},
                grads=jax.tree.map(np.asarray, grads),
                stats=jax.tree.map(np.asarray, stats))


@pytest.fixture(scope="module")
def port_step(jax_step):
    model = port_model(jax_step["variables"])
    tb = {k: torch.from_numpy(v) for k, v in jax_step["batch"].items()}
    task_outs, dn_info = model(tb, step_generators(0, 0))
    losses = cmt_loss(task_outs, dn_info, tb["gt_boxes"], tb["gt_labels"],
                      tb["gt_mask"], jax_step["tasks"])
    losses["loss"].backward()
    return model, {k: float(v.detach()) for k, v in losses.items()}


def test_train_loss_dict_matches_jax(jax_step, port_step):
    _, ours = port_step
    ref = jax_step["losses"]
    assert set(ours) == set(ref)
    assert {"dn_loss_cls", "d0.dn_loss_bbox", "d0.loss_cls"} <= set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_train_gradients_match_jax(jax_step, port_step):
    model, _ = port_step
    ref = from_jax_variables({"params": jax_step["grads"],
                              "batch_stats": jax_step["stats"]})
    names = [n for n, _ in model.named_parameters()]
    assert len(names) > 100
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        err = float(np.abs(g - r).max())
        assert err <= GRAD_TOL * float(np.abs(r).max()) + 1e-6, (
            name, err, float(np.abs(r).max()))


def test_train_batch_stats_match_jax(jax_step, port_step):
    """SECOND/FPN, the pillar encoder's masked BN and the head's
    shared_conv move their running statistics; VoVNet's stay frozen."""
    model, _ = port_step
    ref = from_jax_variables({"params": jax_step["variables"]["params"],
                              "batch_stats": jax_step["stats"]})
    before = from_jax_variables(jax_step["variables"])
    moved = 0
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), ref[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        changed = not np.array_equal(ref[name].numpy(),
                                     before[name].numpy())
        assert changed == ("img_backbone" not in name), name
        moved += changed
    assert moved > 20


def test_adamw_step_matches_optax(rng):
    """Two groups besides the default, a clip that triggers, three steps
    through the warm-up of the cyclic schedules."""
    shapes = {"vehicle_model/img_backbone/w": (3, 4),
              "vehicle_model/img_neck/b": (5,),
              "pts_bbox_head/x": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tree = {"vehicle_model": {"img_backbone": {"w": params[
        "vehicle_model/img_backbone/w"]}, "img_neck": {"b": params[
            "vehicle_model/img_neck/b"]}},
        "pts_bbox_head": {"x": params["pts_bbox_head/x"]}}
    tx, _ = make_optimizer(tree, total_steps=10)
    state = tx.init(tree)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = AdamW([(k.replace("/", "."), p) for k, p in tparams.items()],
                total_steps=10)
    for step in range(3):
        g = {k: (rng.normal(size=s) * 10 ** (step + 1)).astype(np.float32)
             for k, s in shapes.items()}
        gtree = jax.tree_util.tree_map(lambda x: x, tree)
        gtree["vehicle_model"]["img_backbone"]["w"] = g[
            "vehicle_model/img_backbone/w"]
        gtree["vehicle_model"]["img_neck"]["b"] = g["vehicle_model/img_neck/b"]
        gtree["pts_bbox_head"]["x"] = g["pts_bbox_head/x"]
        updates, state = tx.update(gtree, state, tree)
        tree = jax.tree.map(lambda p, u: p + u, tree, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        norm = opt.step()
        np.testing.assert_allclose(
            float(norm), np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                                     for v in g.values())), rtol=1e-5)
        flat = {"vehicle_model/img_backbone/w":
                tree["vehicle_model"]["img_backbone"]["w"],
                "vehicle_model/img_neck/b":
                tree["vehicle_model"]["img_neck"]["b"],
                "pts_bbox_head/x": tree["pts_bbox_head"]["x"]}
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(flat[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {step}")


def _small_train_model(**head):
    model = build_detector(tiny_preset(**SMALL_FUSION_PRESET), train=True,
                           extractor_kwargs=SMALL_FUSION_EXTRACTOR,
                           head_kwargs=dict(SMALL_FUSION_HEAD, max_gt=4,
                                            **head))
    torch.manual_seed(0)
    for p in model.parameters():
        p.data.uniform_(-0.2, 0.2)
    return model


def _loss_and_grads(model, seed):
    tb = {k: torch.from_numpy(v) for k, v in small_fusion_train_batch().items()}
    outs, dn_info = model(tb, step_generators(seed, 0))
    losses = cmt_loss(outs, dn_info, tb["gt_boxes"], tb["gt_labels"],
                      tb["gt_mask"], (("CAR",),))
    losses["loss"].backward()
    return float(losses["loss"].detach()), {
        n: p.grad.clone() for n, p in model.named_parameters()}


def test_checkpointed_layers_replay_their_dropout():
    """With dropout 0.1, DN noise and the grid mask on, the decoder with
    per-layer checkpoints (its recompute draws every mask again from the
    seeds drawn before the layer) gives the gradients of the decoder
    without them; another step seed gives another loss."""
    ref = _small_train_model(remat=False)
    ckpt = _small_train_model(remat=True)
    ckpt.load_state_dict(ref.state_dict())
    loss_ref, g_ref = _loss_and_grads(ref, 3)
    loss_ck, g_ck = _loss_and_grads(ckpt, 3)
    assert loss_ck == pytest.approx(loss_ref, rel=1e-6)
    for n, g in g_ref.items():
        torch.testing.assert_close(g_ck[n], g, rtol=1e-5, atol=1e-7,
                                   msg=n)
    other = _small_train_model(remat=True)
    other.load_state_dict(ref.state_dict())
    assert _loss_and_grads(other, 4)[0] != pytest.approx(loss_ref, rel=1e-6)
