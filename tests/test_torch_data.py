"""The port's synthetic data and partitioners.  The class templates are
numpy-exact copies of the reference's; labels, shifts and noise come from
torch generators, so the rest is held to the reference's invariants."""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import partition, synthetic
from repro_torch.data.pipeline import build_image_task

from test_torch_convert import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("hw", [16, 28])
def test_templates_are_the_references(hw):
    np.testing.assert_array_equal(synthetic._templates(1234, 10, hw),
                                  jsyn._templates(1234, 10, hw))


def test_make_digits_is_a_shifted_noisy_template():
    gen = torch.Generator().manual_seed(0)
    x, y = synthetic.make_digits(gen, 64, hw=16, noise=0.0)
    assert x.shape == (64, 16, 16, 1) and x.dtype == torch.float32
    assert y.shape == (64,) and int(y.min()) >= 0 and int(y.max()) < 10
    tmpl = jsyn._templates(1234, 10, 16)
    for img, label in zip(x[..., 0].numpy(), y.numpy()):
        # noise 0: each image is its template rolled by some (dy, dx) in [-2, 2]
        assert any(np.allclose(img, np.roll(np.roll(tmpl[label], dy, 0), dx, 1))
                   for dy in range(-2, 3) for dx in range(-2, 3))
    x2, y2 = synthetic.make_digits(torch.Generator().manual_seed(0), 64,
                                   hw=16, noise=0.0)
    assert torch.equal(x, x2) and torch.equal(y, y2)


def test_partitions_cover_disjointly():
    gen = torch.Generator().manual_seed(1)
    idx = partition.iid(gen, 103, 4)
    assert idx.shape == (4, 25)
    assert len(set(idx.flatten().tolist())) == 100
    labels = torch.arange(200) % 10
    idx = partition.shard_non_iid(gen, labels, 10, 2)
    assert idx.shape == (10, 20)
    assert sorted(idx.flatten().tolist()) == list(range(200))
    for row in idx:
        # two label-sorted shards of 10: at most 2 + 2 classes per client
        assert len(set(labels[row].tolist())) <= 4


def test_build_image_task_shapes_and_non_iid_skew():
    task = build_image_task(0, K=5, n_private=300, n_open=40, n_test=30,
                            hw=16, device="cpu")
    assert task.x_clients.shape == (5, 60, 16, 16, 1)
    assert task.y_clients.shape == (5, 60)
    assert task.open_x.shape == (40, 16, 16, 1)
    assert task.x_test.shape == (30, 16, 16, 1)
    per_client = [len(set(r.tolist())) for r in task.y_clients]
    assert max(per_client) <= 4          # strong label skew
    iid = build_image_task(0, K=5, n_private=300, n_open=40, n_test=30,
                           distribution="iid", device="cpu")
    assert min(len(set(r.tolist())) for r in iid.y_clients) >= 6
    dirichlet = build_image_task(0, 5, 300, 40, 30,
                                 distribution="dirichlet:0.5", device="cpu")
    assert dirichlet.x_clients.shape[0] == 5
    assert dirichlet.y_clients.shape == dirichlet.x_clients.shape[:2]
