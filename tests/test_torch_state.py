"""Port state, tables and package boundary (mbe_tpu_torch vs mbe_tpu).

Every integer leaf must equal the JAX package's exactly; float leaves
here are constants and must be equal too (tolerance 0)."""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mbe_tpu.models import state as jst
from mbe_tpu.tables import T as JT
from mbe_tpu_torch.models import state as st
from mbe_tpu_torch.tables import T

torch.set_num_threads(1)

PKG = Path(__file__).resolve().parent.parent / "mbe_tpu_torch"


def _assert_state_equal(port_np, jax_state):
    """port state (numpy leaves, JAX dtypes) == JAX state, leaf for leaf."""
    for part in ("cur", "prev", "enh"):
        pp, jp = getattr(port_np, part), getattr(jax_state, part)
        assert (pp is None) == (jp is None), part
        if jp is None:
            continue
        for k in st.PARMS_FIELDS:
            a, b = getattr(pp, k), np.asarray(getattr(jp, k))
            assert a.dtype == b.dtype, f"{part}.{k}: {a.dtype} != {b.dtype}"
            np.testing.assert_array_equal(a, b, err_msg=f"{part}.{k}")
    for k in ("comfort_rng", "lcg_prime"):
        a, b = getattr(port_np, k), np.asarray(getattr(jax_state, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("carry_enh", [True, False], ids=["enh", "noenh"])
@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
def test_init_state_matches_jax(seeded, carry_enh):
    c = 6
    # seed 0 takes the 0x6D25357B substitution; 0xFFFFFFFF the top of uint32
    seeds = (np.array([0, 1, 12345, 0x6D25357B, 0xFFFFFFFF, 53125], np.uint32)
             if seeded else None)
    ours = st.init_state(c, rng_seed=seeds, carry_enh=carry_enh)
    ref = jst.init_state(c, rng_seed=seeds, carry_enh=carry_enh)
    _assert_state_equal(st.state_to_numpy(ours), ref)


def test_state_numpy_round_trip():
    """state_from_numpy(JAX state) -> state_to_numpy is the identity leaf
    for leaf, uint32 leaves included (held as int64 in between)."""
    rng = np.random.default_rng(0)
    ref = jax.tree.map(np.asarray, jst.init_state(5, rng_seed=np.arange(5, dtype=np.uint32)))
    ref = dataclasses.replace(
        ref, comfort_rng=rng.integers(0, 1 << 16, (3, 5)).astype(np.uint32),
        cur=dataclasses.replace(
            ref.cur, swn=np.array([0, 1, 2**31, 2**32 - 1, 7], np.uint32),
            Ml=rng.random((57, 5)).astype(np.float32)))
    ours = st.state_from_numpy(ref, "cpu")
    assert ours.cur.swn.dtype == torch.int64
    assert int(ours.cur.swn[3]) == 2**32 - 1
    _assert_state_equal(st.state_to_numpy(ours), ref)


def test_select_cases_first_match_wins():
    a = st.init_state(4).cur
    b = dataclasses.replace(a, L=torch.full((4,), 20, dtype=torch.int32))
    c = dataclasses.replace(a, L=torch.full((4,), 30, dtype=torch.int32))
    m1 = torch.tensor([True, False, True, False])
    m2 = torch.tensor([True, True, False, False])
    out = st.select_cases([(m1, b), (m2, c)], a)
    assert out.L.tolist() == [20, 30, 20, 39]
    assert out.Ml is a.Ml


def test_select_and_select_tree_by_lane():
    a, b = st.init_state(3), st.init_state(3, rng_seed=np.uint32(9), carry_enh=True)
    b.cur.Ml.fill_(2.0)
    m = torch.tensor([True, False, True])
    got = st.select(m, b.cur, a.cur)
    assert got.Ml[:, 1].eq(1.0).all() and got.Ml[:, 0].eq(2.0).all()
    tree = st.select_tree(m, b, a)
    assert torch.equal(tree.comfort_rng[:, 0], b.comfort_rng[:, 0])
    assert torch.equal(tree.comfort_rng[:, 1], a.comfort_rng[:, 1])
    assert tree.enh.Ml[:, 2].eq(1.0).all()


def test_headroom_reset_matches_jax():
    rng = np.random.default_rng(1)
    ref = jax.tree.map(np.asarray, jst.init_state(3))
    cur = dataclasses.replace(
        ref.cur, errorRate=np.float32([0.1, 0.2, 0.3]),
        PHIl=rng.random((57, 3)).astype(np.float32),
        L=np.int32([10, 20, 30]), repeatCount=np.int32([5, 6, 7]))
    ref = dataclasses.replace(ref, cur=cur)
    ours = st.state_from_numpy(ref, "cpu")
    got = st.imbe_headroom_reset(ours.cur)
    want = jst.imbe_headroom_reset(cur)
    for k in st.PARMS_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.asarray(getattr(want, k)).astype(
                getattr(got, k).numpy().dtype), err_msg=k)


def test_tables_match_jax_loader():
    """The port reads the npz by path and recomputes the derived entries."""
    assert set(T.keys()) == set(JT.keys())
    for k in JT.keys():
        np.testing.assert_array_equal(getattr(T, k), getattr(JT, k), err_msg=k)


def test_precision_pins():
    import mbe_tpu_torch  # noqa: F401  (the pins run at import)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_imports_neither_jax_nor_mbe_tpu():
    """Static scan: no module of mbe_tpu_torch imports jax or mbe_tpu."""
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "mbe_tpu"), f"{path}: {name}"
