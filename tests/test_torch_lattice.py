"""The port's PLT eigenmode generator against the JAX package's.

``zeldovich_tpu_torch/ops/lattice.py`` on CPU tensors against
``zeldovich_tpu/ops/lattice.py`` (numpy + scipy) on the same inputs: the
dynamical matrix to 1e-12 of its largest entry; the tables at N = 8 and
16 under ``check_table``'s three rules (eigenvalues to 1e-12 everywhere;
eigenvectors to 1e-10 where the chosen eigenvalue is 1e-6 from the other
two; elsewhere a unit vector in JAX's eigenspace), which the two
eigensolvers (torch's, LAPACK's through numpy) need where eigenvalues
are degenerate; the physics invariants of ``tests/test_lattice.py``;
``save_eigmodes`` byte for byte; and the generator script.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from zeldovich_tpu.ops import lattice as jlattice
from zeldovich_tpu.ops import plt as jplt
from zeldovich_tpu_torch.ops import lattice
from zeldovich_tpu_torch.ops.lattice import (
    check_table, dynamical_matrix, generate_eigmodes_table, growing_mode,
)
from zeldovich_tpu_torch.ops.plt import load_eigmodes, save_eigmodes

torch.set_num_threads(1)

REPO = Path(__file__).parent.parent


def _eps(k):
    return dynamical_matrix(torch.tensor(k, dtype=torch.float64)).numpy()


def _table_kvecs(N):
    wrap = lattice.wrapped_index(N, "cpu").numpy()
    return 2 * np.pi / N * np.stack(
        np.meshgrid(wrap, wrap, np.arange(N // 2 + 1), indexing="ij"), -1
    ).astype(np.float64)


def test_dynamical_matrix_matches_jax():
    """64 seeded k vectors in [-3 pi, 3 pi]^3, most outside the first
    Brillouin zone, and k = 0."""
    rng = np.random.default_rng(2024)
    k = np.concatenate([rng.uniform(-3 * np.pi, 3 * np.pi, size=(64, 3)),
                        np.zeros((1, 3))])
    assert (np.abs(k) > np.pi).any(axis=1).sum() > 32
    want = jlattice.dynamical_matrix(k)
    got = _eps(k)
    assert got.shape == want.shape == (65, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_dynamical_matrix_keeps_the_batch_shape():
    k = np.random.default_rng(1).uniform(-np.pi, np.pi, size=(2, 5, 3))
    got = _eps(k)
    assert got.shape == (2, 5, 3, 3)
    np.testing.assert_allclose(got, _eps(k.reshape(-1, 3)).reshape(2, 5, 3, 3),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("N", [8, 16])
def test_table_matches_jax(N):
    want = jlattice.generate_eigmodes_table(N)
    got = generate_eigmodes_table(N, device="cpu")
    assert got.shape == want.shape == (N, N, N // 2 + 1, 4) and got.dtype == np.float64
    counts = check_table(got, want, jlattice.dynamical_matrix(_table_kvecs(N)))
    # the second rule covers most entries, the third the degenerate rest
    # (the R corner and the high-symmetry lines)
    assert counts["separated"] > 10 * counts["degenerate"] > 0
    assert counts["separated"] + counts["degenerate"] == got[..., 0].size - 1


@pytest.mark.parametrize("rule", ["eigenvalue", "vector", "norm", "dot", "residual"])
def test_check_table_catches_a_wrong_table(rule):
    N = 8
    want = jlattice.generate_eigmodes_table(N)
    eps = jlattice.dynamical_matrix(_table_kvecs(N))
    check_table(want, want, eps)
    bad = want.copy()
    corner = (N // 2,) * 3  # eps = I/3: any unit vector lies in its eigenspace
    if rule == "eigenvalue":
        bad[1, 0, 0, 3] += 1e-11
    elif rule == "vector":
        bad[1, 2, 1, :3] *= -1
    elif rule == "norm":
        bad[corner][:3] *= 1 + 1e-9
    elif rule == "dot":
        bad[corner][:3] *= -1
    else:  # split the eigenvalue by less than 1e-6: still degenerate
        eps[corner] += np.diag([0.0, 0.0, 1e-8])
    with pytest.raises(ValueError, match=f"rule '{rule}'"):
        check_table(bad, want, eps)


@pytest.mark.parametrize("batch", [None, 7], ids=["one_call", "eigh_in_7s"])
def test_growing_mode_matches_jax_away_from_degeneracy(monkeypatch, batch):
    if batch:
        monkeypatch.setattr(lattice, "_EIGH_BATCH", batch)
    rng = np.random.default_rng(7)
    k = rng.uniform(-np.pi, np.pi, size=(200, 3))
    khat = k / np.linalg.norm(k, axis=1, keepdims=True)
    eps = jlattice.dynamical_matrix(k)
    jv, jw = jlattice.growing_mode(eps, khat)
    v, w = growing_mode(torch.tensor(eps), torch.tensor(khat))
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-14)
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-12)
    assert ((v.numpy() * khat).sum(1) >= 0).all()


def _kohn_sum_rule():
    """tr eps(k) = 1 for all k != 0 (exact for 1/r^2 forces)."""
    ks = np.random.default_rng(0).uniform(-np.pi, np.pi, size=(30, 3))
    np.testing.assert_allclose(np.trace(_eps(ks), axis1=-2, axis2=-1), 1.0, atol=1e-12)


def _continuum_limit():
    """k -> 0: growing eigenvalue -> 1, eigenvector -> k_hat."""
    k = np.array([[0.02, -0.013, 0.007]])
    khat = k / np.linalg.norm(k)
    v, w = growing_mode(torch.tensor(_eps(k)), torch.tensor(khat))
    assert w[0].item() == pytest.approx(1.0, abs=1e-4)
    assert np.dot(v[0].numpy(), khat[0]) == pytest.approx(1.0, abs=1e-6)


def _corner_isotropy():
    """At k = (pi, pi, pi) all axes are equivalent: eps = I/3."""
    eps = _eps(np.array([[np.pi, np.pi, np.pi]]))[0]
    np.testing.assert_allclose(eps, np.eye(3) / 3, atol=1e-10)
    np.testing.assert_allclose(np.linalg.eigvalsh(eps), 1.0 / 3.0, atol=1e-12)


def _axis_symmetry():
    """k along x: eigenvectors are the coordinate axes."""
    eps = _eps(np.array([[2.0, 0.0, 0.0]]))[0]
    np.testing.assert_allclose(eps - np.diag(np.diag(eps)), 0, atol=1e-12)
    assert eps[1, 1] == pytest.approx(eps[2, 2], rel=1e-12)


def _ewald_parameter_independence():
    k = torch.tensor([[1.0, -0.7, 0.3], [3.0, 2.9, -0.1]], dtype=torch.float64)
    e1 = dynamical_matrix(k, alpha=2.0, rcut=3.6, mcut=4).numpy()
    e2 = dynamical_matrix(k, alpha=2.6, rcut=3.0, mcut=6).numpy()
    np.testing.assert_allclose(e1, e2, atol=1e-12)


def _reciprocal_periodicity():
    k = np.array([[0.9, -0.4, 0.2]])
    np.testing.assert_allclose(_eps(k), _eps(k + 2 * np.pi * np.array([[1, -2, 1]])),
                               atol=1e-11)


def _x_point_values():
    """X = (pi, 0, 0): the fast longitudinal mode and the unstable
    transverse pair, pinned to the JAX test's converged values."""
    w = np.sort(np.linalg.eigvalsh(_eps(np.array([[np.pi, 0.0, 0.0]]))[0]))
    assert w[2] > 1.0 > 0.0 > w[0]
    assert w[0] == pytest.approx(w[1], abs=1e-12)
    assert w.sum() == pytest.approx(1.0, abs=1e-12)
    assert w[2] == pytest.approx(1.1042355561, abs=1e-8)
    assert w[0] == pytest.approx(-0.0521177781, abs=1e-8)


def _real_space_tensor_is_the_hessian():
    """s(R) equals minus a numeric Hessian of erfc(alpha r)/r (math.erfc,
    independent of torch.special.erfc and of the closed-form derivatives)."""
    alpha = 2.0
    R, s = lattice._real_space_tensor(alpha, 2.2, "cpu")
    R, s = R.numpy(), s.numpy()

    def f(x):
        r = np.linalg.norm(x)
        return math.erfc(alpha * r) / r

    h = 1e-5
    for idx in [0, 7, len(R) // 2, len(R) - 1]:
        x0 = R[idx]
        H = np.empty((3, 3))
        for a in range(3):
            for b in range(3):
                ea, eb = np.eye(3)[a] * h, np.eye(3)[b] * h
                H[a, b] = (f(x0 + ea + eb) - f(x0 + ea - eb)
                           - f(x0 - ea + eb) + f(x0 - ea - eb)) / (4 * h * h)
        np.testing.assert_allclose(s[idx], -H, rtol=2e-5, atol=1e-7)


def _small_table():
    """tests/test_lattice.py::test_table_generation_small on the port."""
    N = 8
    t = generate_eigmodes_table(N, device="cpu")
    assert t.shape == (N, N, N // 2 + 1, 4)
    np.testing.assert_allclose(np.linalg.norm(t[..., :3], axis=-1), 1.0, atol=1e-10)
    assert t[..., 3].min() > -0.5 and t[..., 3].max() < 1.5
    assert t[N // 2, N // 2, N // 2, 3] == pytest.approx(1 / 3, abs=1e-9)
    assert t[1, 0, 0, 3] == pytest.approx(1.0, abs=0.05)
    np.testing.assert_array_equal(t[0, 0, 0], [0.0, 0.0, 1.0, 1.0])
    assert ((t[..., :3] * _table_kvecs(N)).sum(-1) >= -1e-9).all()


INVARIANTS = {f.__name__.lstrip("_"): f for f in (
    _kohn_sum_rule, _continuum_limit, _corner_isotropy, _axis_symmetry,
    _ewald_parameter_independence, _reciprocal_periodicity, _x_point_values,
    _real_space_tensor_is_the_hessian, _small_table,
)}


@pytest.mark.parametrize("name", list(INVARIANTS))
def test_lattice_invariant(name):
    INVARIANTS[name]()


def test_save_eigmodes_writes_the_jax_bytes(tmp_path):
    table = generate_eigmodes_table(8, device="cpu")
    jplt.save_eigmodes(tmp_path / "jax", table)
    save_eigmodes(tmp_path / "numpy", table)
    save_eigmodes(tmp_path / "tensor", torch.from_numpy(table))
    want = (tmp_path / "jax").read_bytes()
    assert len(want) == 4 + 8 * table.size
    assert (tmp_path / "numpy").read_bytes() == want
    assert (tmp_path / "tensor").read_bytes() == want
    np.testing.assert_array_equal(load_eigmodes(tmp_path / "numpy"), table)
    with pytest.raises(ValueError, match="shape"):
        save_eigmodes(tmp_path / "bad", table[:, :4])


def test_generator_fills_a_given_array_and_checks_it(tmp_path):
    out = np.memmap(tmp_path / "t", dtype="<f8", mode="w+", shape=(8, 8, 5, 4))
    assert generate_eigmodes_table(8, device="cpu", out=out) is out
    np.testing.assert_array_equal(out, generate_eigmodes_table(8, device="cpu"))
    with pytest.raises(ValueError, match="want float64"):
        generate_eigmodes_table(8, device="cpu", out=np.empty((8, 8, 5, 4), np.float32))


def test_script_writes_the_saved_table(tmp_path):
    out = tmp_path / "eigmodes8"
    run = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_generate_eigmodes.py"), "8",
         str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "wrote" in run.stdout and "CPU" in run.stdout
    save_eigmodes(tmp_path / "want", generate_eigmodes_table(8, device="cpu"))
    assert out.read_bytes() == (tmp_path / "want").read_bytes()


def test_generator_runs_on_the_card_by_default():
    """The default device is the card: without one the first tensor
    raises, and nothing carries on on the CPU."""
    if torch.cuda.is_available():
        assert generate_eigmodes_table(8).shape == (8, 8, 5, 4)
    else:
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
            generate_eigmodes_table(8)


@pytest.mark.parametrize("N", [16, 32])
def test_plt_run_on_generated_tables_matches_jax(tmp_path, N):
    """The slice: a 16^3 PLT run of the port on the port's N table against
    the JAX package's run on its own (the lookup's direct gather, every
    N-th entry), float64 to 1e-12.  The entries where the two eigensolvers
    pick different bases (two Nyquist components) reach no live mode."""
    from zeldovich_tpu.models.pipeline import Zeldovich as JZeldovich
    from zeldovich_tpu.utils.params import Parameters
    from zeldovich_tpu_torch.models.pipeline import Zeldovich

    jplt.save_eigmodes(tmp_path / "jax", jlattice.generate_eigmodes_table(N))
    save_eigmodes(tmp_path / "port", generate_eigmodes_table(N, device="cpu"))
    keys = dict(
        BoxSize=100.0, NP=16**3, CPD=8, ICFormat="RVZel", InitialRedshift=49.0,
        InitialConditionsDirectory=str(tmp_path / "ic"), ZD_Seed=97531,
        ZD_NumBlock=2, ZD_Pk_scale=1.0, ZD_Pk_norm=8.0, ZD_Pk_sigma=0.02,
        ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(REPO / "zeldovich_tpu" / "assets" / "wmap1new.pow"),
        ZD_Version=2, ZD_qPLT=1, ZD_qPLT_rescale=1, ZD_PLT_target_z=5.0,
    )
    want = np.asarray(JZeldovich(Parameters.from_dict(
        dict(keys, ZD_PLT_filename=str(tmp_path / "jax")))).xspace_half_pair())
    got = Zeldovich(Parameters.from_dict(dict(keys, ZD_PLT_filename=str(tmp_path / "port"))),
                    device="cpu").xspace_half_pair().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
