"""The port's training augmentation (yolov3_tpu_torch/ops/augment.py) against
the JAX package's ``augment_batch``, on the CPU.

The two packages draw differently by design (threefry keys there, a
``torch.Generator`` here), so the JAX package's draws are taken with its own
key splits (``_jax_draws`` mirrors ``augment_batch``'s) and given to the
port's ``apply_augment``; the result is compared with ``augment_batch``
itself on the same key.

Tolerances: on an image whose every pixel value is distinct (``_ramp``),
with the geometric transforms alone (flip, scale-shift, mosaic), images and
labels equal: every output pixel is the same source pixel or the same fill,
so the gathered indices are equal; with the colour transforms, on random
images, images within 1e-6 and labels within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.ops.augment import augment_batch as jax_augment_batch
from yolov3_tpu_torch.ops import augment as taug

from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

B, H, W, M = 5, 32, 40, 6


def _labels(seed):
    rng = np.random.RandomState(seed)
    labels = np.zeros((B, M, 6), np.float32)
    for b in range(B):
        for m in range(rng.randint(1, M)):
            x0, y0 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.35 + 0.02
            labels[b, m] = [x0, y0, x0 + w, y0 + h, 1, rng.randint(3)]
    return labels


def _ramp():
    """Every pixel of every image a distinct value in (0, 1)."""
    n = B * H * W * 3
    return ((np.arange(n, dtype=np.float64) + 1) / (n + 1)).astype(np.float32).reshape(B, H, W, 3)


def _random_images(seed):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


def _jax_draws(key, batch, flip=True, scale_jitter=0.25, brightness=0.1, contrast=0.1,
               mosaic=0.0, hue=0.0, saturation=0.0, exposure=0.0):
    """``augment_batch``'s random values for ``key``, by its own key splits,
    in the port's ``draws`` layout."""
    draws = {}
    if mosaic > 0:
        km, key = jax.random.split(key)
        keys = jax.random.split(km, batch + 1)
        draws["mosaic_center"] = np.stack([np.asarray(jax.random.uniform(
            k, (2,), minval=0.3, maxval=0.7)) for k in keys[1:]])
        draws["mosaic_take"] = np.asarray(jax.random.bernoulli(keys[0], float(mosaic), (batch,)))
    rows = {}
    for k in jax.random.split(key, batch):
        kf, ks, ko, kc, kh = jax.random.split(k, 5)
        if flip:
            rows.setdefault("flip", []).append(np.asarray(jax.random.bernoulli(kf)))
        if scale_jitter > 0:
            s = jax.random.uniform(ks, (), minval=1.0 - scale_jitter, maxval=1.0)
            rows.setdefault("scale", []).append(np.asarray(s))
            rows.setdefault("offset", []).append(np.asarray(
                jax.random.uniform(ko, (2,), minval=0.0, maxval=1.0) * (1.0 - s)))
        khue, ksat, kexp = jax.random.split(kh, 3)
        if hue > 0:
            rows.setdefault("hue", []).append(np.asarray(
                jax.random.uniform(khue, (), minval=-hue, maxval=hue)))
        for name, bound, kk in (("saturation", saturation, ksat), ("exposure", exposure, kexp)):
            if bound > 1:
                lb = jnp.log(jnp.float32(bound))
                rows.setdefault(name, []).append(np.asarray(
                    jnp.exp(jax.random.uniform(kk, (), minval=-lb, maxval=lb))))
        if brightness > 0 or contrast > 0:
            kb, kcon = jax.random.split(kc)
            rows.setdefault("brightness", []).append(np.asarray(
                jax.random.uniform(kb, (), minval=-brightness, maxval=brightness)))
            rows.setdefault("contrast", []).append(np.asarray(
                jax.random.uniform(kcon, (), minval=1.0 - contrast, maxval=1.0 + contrast)))
    draws.update({k: np.stack(v) for k, v in rows.items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


GEOMETRIC = {
    "flip": dict(flip=True, scale_jitter=0.0, brightness=0.0, contrast=0.0),
    "scale_jitter": dict(flip=False, scale_jitter=0.4, brightness=0.0, contrast=0.0),
    "mosaic": dict(flip=False, scale_jitter=0.0, brightness=0.0, contrast=0.0, mosaic=0.7),
    "geometric": dict(flip=True, scale_jitter=0.3, brightness=0.0, contrast=0.0, mosaic=0.6),
}
COLOUR = {
    "brightness_contrast": dict(flip=False, scale_jitter=0.0, brightness=0.2, contrast=0.3),
    "hue": dict(flip=False, scale_jitter=0.0, brightness=0.0, contrast=0.0, hue=0.2),
    "saturation": dict(flip=False, scale_jitter=0.0, brightness=0.0, contrast=0.0,
                       saturation=1.5),
    "exposure": dict(flip=False, scale_jitter=0.0, brightness=0.0, contrast=0.0, exposure=1.8),
    "defaults": dict(),
    "all": dict(flip=True, scale_jitter=0.25, brightness=0.1, contrast=0.1, mosaic=0.5,
                hue=0.1, saturation=1.5, exposure=1.5),
}


def _both(images, labels, seed, options):
    key = jax.random.PRNGKey(seed)
    want_im, want_lb = jax_augment_batch(jnp.asarray(images), jnp.asarray(labels), key,
                                         **options)
    got_im, got_lb = taug.apply_augment(torch.from_numpy(images), torch.from_numpy(labels),
                                        _jax_draws(key, B, **options))
    return ((got_im.numpy(), got_lb.numpy()), (np.asarray(want_im), np.asarray(want_lb)))


@pytest.mark.parametrize("name", sorted(GEOMETRIC))
@pytest.mark.parametrize("seed", [0, 1])
def test_geometric_transforms_gather_the_same_pixels(name, seed):
    (got_im, got_lb), (want_im, want_lb) = _both(_ramp(), _labels(seed), seed, GEOMETRIC[name])
    np.testing.assert_array_equal(got_im, want_im)
    np.testing.assert_allclose(got_lb, want_lb, rtol=0, atol=1e-6)
    assert not np.array_equal(got_im, _ramp())  # the draws did transform the batch


@pytest.mark.parametrize("name", sorted(COLOUR))
@pytest.mark.parametrize("seed", [0, 3])
def test_colour_transforms_match_jax(name, seed):
    (got_im, got_lb), (want_im, want_lb) = _both(_random_images(seed), _labels(seed), seed,
                                                 COLOUR[name])
    np.testing.assert_allclose(got_im, want_im, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_lb, want_lb, rtol=0, atol=1e-6)


def test_mosaic_keeps_the_first_valid_boxes_in_source_order():
    """All of the quadrants' boxes are more than M, so the stable sort on
    validity decides which M survive; the JAX package keeps them in source
    order, and so does the port."""
    labels = np.zeros((B, M, 6), np.float32)
    labels[:, :, :4] = [0.1, 0.1, 0.4, 0.4]
    labels[:, :, 4] = 1.0
    labels[:, :, 5] = np.arange(B * M).reshape(B, M) % 7
    options = dict(flip=False, scale_jitter=0.0, brightness=0.0, contrast=0.0, mosaic=1.0)
    (got_im, got_lb), (want_im, want_lb) = _both(_ramp(), labels, 5, options)
    np.testing.assert_allclose(got_lb, want_lb, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_lb[:, :, 5], labels[:, :, 5])  # image b's own boxes first


def test_source_indices_truncate_after_the_jax_operation_order():
    """``(arange(n) / n − lo) / span · n``, clipped and truncated: at an
    offset that puts canvas positions exactly on source boundaries, the
    indices are those of the same expression in numpy float32."""
    n = 40
    lo = torch.tensor([0.25, 0.1, 0.0], dtype=torch.float32)
    span = torch.tensor([0.5, 0.8, 1.0], dtype=torch.float32)
    index, valid = taug.source_indices(n, lo, span)
    ar = np.arange(n, dtype=np.float32) / np.float32(n)
    t = (ar[None, :] - lo.numpy()[:, None]) / span.numpy()[:, None]
    np.testing.assert_array_equal(index.numpy(), np.clip(t * np.float32(n), 0, n - 1)
                                  .astype(np.int32))
    np.testing.assert_array_equal(valid.numpy(), (t >= 0) & (t < 1.0))


def test_draws_come_from_the_step_generator_and_are_checked():
    a = taug.draw_augment(B, taug.step_generator(3, 7), **COLOUR["all"])
    b = taug.draw_augment(B, taug.step_generator(3, 7), **COLOUR["all"])
    c = taug.draw_augment(B, taug.step_generator(3, 8), **COLOUR["all"])
    assert a.keys() == b.keys() == set(_jax_draws(jax.random.PRNGKey(0), B, **COLOUR["all"]))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert a["flip"].dtype == a["mosaic_take"].dtype == torch.bool
    s = a["scale"]
    assert bool(((s >= 0.75) & (s <= 1.0)).all())
    assert bool(((a["offset"] >= 0) & (a["offset"] <= (1 - s)[:, None])).all())
    assert bool(((a["saturation"] >= 1 / 1.5) & (a["saturation"] <= 1.5)).all())
    assert set(taug.draw_augment(B, taug.step_generator(0, 0), flip=False, scale_jitter=0,
                                 brightness=0, contrast=0)) == set()
    for name in ("saturation", "exposure"):
        with pytest.raises(ValueError, match=f"{name} is a scale BOUND > 1"):
            taug.draw_augment(B, taug.step_generator(0, 0), **{name: 0.5})
    with pytest.raises(TypeError):
        taug.draw_augment(B, taug.step_generator(0, 0), jitter=0.2)


def test_train_step_augments_by_seed_and_step():
    """The step draws from (seed, the state's step): the same state gives the
    same augmented batch, the next step another."""
    images = torch.from_numpy(_random_images(0))
    labels = torch.from_numpy(_labels(0))
    options = COLOUR["all"]

    def at(step):
        draws = taug.draw_augment(B, taug.step_generator(11, step), **options)
        return taug.apply_augment(images, labels, draws)

    first, again, second = at(0), at(0), at(1)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert not torch.equal(first[0], second[0])
    assert first[0].shape == images.shape and first[1].shape == labels.shape
    assert bool(((first[0] >= 0) & (first[0] <= 1)).all())
