"""B1 (label propagation round): the port's plain version and wrapper
against the JAX reference's jnp oracle and Pallas kernel (interpret mode).

All outputs are int32, so the tolerance is exact equality. The kernel
itself runs only on an NVIDIA card: its tests are in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import label_prop as jax_label_prop  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import label_prop, ops, ref  # noqa: E402

# the (B, N, Pallas block) sweep of tests/test_kernels.py::TestLabelProp
SWEEP = [(2, 30, 16), (4, 50, 2048), (8, 300, 64)]


def round_inputs(B, N, seed, random_labels):
    """int32 labels, three int32 link arrays in [-1, N), bool active."""
    rng = np.random.default_rng(seed)
    active = rng.random((B, N)) < 0.7
    if random_labels:
        labels = rng.integers(0, N + 1, (B, N)).astype(np.int32)
    else:
        labels = np.where(active, np.arange(N, dtype=np.int32)[None], N)
        labels = labels.astype(np.int32)
    links = [rng.integers(-1, N, (B, N)).astype(np.int32) for _ in range(3)]
    return labels, links, active


def to_torch(labels, links, active):
    return ([torch.as_tensor(labels)] + [torch.as_tensor(a) for a in links]
            + [torch.as_tensor(active)])


@pytest.mark.parametrize("random_labels", [False, True])
@pytest.mark.parametrize("B,N,bn", SWEEP)
def test_plain_round_matches_jax_oracle_and_pallas(B, N, bn, random_labels):
    labels, links, active = round_inputs(B, N, B * N + random_labels,
                                         random_labels)
    jargs = [jnp.asarray(labels)] + [jnp.asarray(a) for a in links] \
        + [jnp.asarray(active)]
    want = np.asarray(jax_ref.label_prop_round(*jargs))
    pallas = np.asarray(jax_label_prop.label_prop_round(*jargs, bn=bn))
    got = ref.label_prop_round(*to_torch(labels, links, active))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("B,N,bn", SWEEP)
def test_wrapper_takes_plain_path_on_cpu_and_counts_no_launch(B, N, bn):
    labels, links, active = round_inputs(B, N, 7 * N, True)
    args = to_torch(labels, links, active)
    before = label_prop.label_prop_round.launches
    flag = torch.zeros(1, dtype=torch.int32)
    got = ops.label_prop_round(*args, changed=flag)
    assert label_prop.label_prop_round.launches == before
    want = ref.label_prop_round(*args)
    assert torch.equal(got, want)
    assert int(flag) == int(bool((want != args[0]).any()))


def test_change_flag_stays_clear_at_a_fixpoint():
    labels, links, active = round_inputs(4, 64, 3, False)
    args = to_torch(labels, links, active)
    flag = torch.zeros(1, dtype=torch.int32)
    for _ in range(64):          # iterate to the fixpoint
        flag.zero_()
        args[0] = label_prop.label_prop_round(*args, changed=flag)
        if not int(flag):
            break
    assert int(flag) == 0
    out = label_prop.label_prop_round(*args, changed=flag)
    assert torch.equal(out, args[0]) and int(flag) == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    labels, links, active = round_inputs(2, 30, 1, True)
    args = to_torch(labels, links, active)
    flag = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="labels must be torch.int32"):
        label_prop.label_prop_round(args[0].long(), *args[1:], changed=flag)
    with pytest.raises(TypeError, match="active must be torch.bool"):
        label_prop.label_prop_round(*args[:4], args[4].to(torch.uint8),
                                    changed=flag)
    with pytest.raises(ValueError, match="contiguous"):
        label_prop.label_prop_round(args[0], args[1].t().contiguous().t(),
                                    *args[2:], changed=flag)
    with pytest.raises(ValueError, match="shape"):
        label_prop.label_prop_round(args[0], args[1][:, :5].contiguous(),
                                    *args[2:], changed=flag)
    with pytest.raises(ValueError, match="changed must be an int32"):
        label_prop.label_prop_round(*args, changed=flag.long())


def test_bound_counts_each_operand_once():
    # 4 label + 1 active bytes read and 4 written per element; 12 link
    # bytes read per active element only
    assert label_prop.bound_ms(256, 1000, 256 * 1000) == pytest.approx(
        21 * 256 * 1000 / 3.35e12 * 1e3)
    assert label_prop.bound_ms(256, 1000, 3000) == pytest.approx(
        (9 * 256 * 1000 + 12 * 3000) / 3.35e12 * 1e3)
