"""Swing's pair-pass kernel (``csrc/swing.cu``) on the card against its plain
PyTorch version.

The kernel sums each score in 64-bit fixed point (``w * 2^32`` a term), the
plain version the same float32 weights in float64: the scores agree within
rtol 1e-7 plus 2^-32 a term, two launches are bit-identical, and a row block
is the rows of the whole. The top-k is held by ids where no two exact scores
lie within 1e-5 relative. 2000 users are more than the kernel's grid on an
H100 (132 SMs x 4 blocks), so its blocks take several users each. Card-only (``-m cuda``); the plain version's CPU
tests are in ``test_torch_cf_models.py``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch


def _lists(n_users, n_items, density, seed, device):
    from librecommender_tpu_torch.ops import swing

    m = sp.random(n_users, n_items, density=density, random_state=seed,
                  format="csr", dtype=np.float32)
    m.data[:] = 1.0
    return swing.interaction_lists(m, device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_users,n_items,density,alpha", [
    (300, 120, 0.1, 1.0), (64, 700, 0.05, 0.5), (500, 60, 0.3, 2.0),
    (2000, 300, 0.03, 1.0)])
def test_swing_kernel_matches_plain(n_users, n_items, density, alpha):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    from librecommender_tpu_torch.ops import swing

    lists = _lists(n_users, n_items, density, 0, "cuda")
    swing.reset_launches()
    got = swing.swing_pairs(lists, n_items, alpha)
    again = swing.swing_pairs(lists, n_items, alpha)
    block = swing.swing_pairs(lists, n_items, alpha, (n_items // 3, n_items // 2))
    torch.cuda.synchronize()
    assert swing.launches == 3
    want = swing.swing_pairs_plain(lists, n_items, alpha, (0, n_items))
    # w >= 1 / (alpha + n_items): at most this many terms a score
    terms = torch.ceil(want * (alpha + n_items))
    assert torch.equal(got, again)
    assert torch.equal(block, got[n_items // 3:n_items // 2])
    assert (torch.abs(got - want) <= 1e-7 * want.abs() + terms * 2.0 ** -32).all()
    ids, vals = swing.swing_topk(lists, n_items, alpha, 10)
    plain_ids = swing.topk_of_scores(want, 10)[0].cpu().numpy()
    exact = want.cpu().numpy()
    for r, j in zip(*np.nonzero(ids != plain_ids)):
        a, b = ids[r, j], plain_ids[r, j]
        assert a >= 0 and b >= 0, f"row {r}: a list is shorter on one side"
        assert abs(exact[r, a] - exact[r, b]) <= 1e-5 * abs(exact[r, b])
    np.testing.assert_allclose(vals, np.take_along_axis(
        exact, np.maximum(ids, 0), 1).astype(np.float32) * (ids >= 0), rtol=1e-6)
