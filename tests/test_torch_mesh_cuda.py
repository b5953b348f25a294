"""The mesh on the card: two ranks sharing one GPU over gloo (NCCL refuses
two ranks on one device), started by ``launch.mesh.spawn``.  Each
collective the sharded paths use on CUDA tensors (float32, bfloat16,
int32, int8; the Megatron pairs' backward), K1 scaled on a column shard
and with its int32 epilogue on a row shard against the whole weight's K1
(bitwise), and a 2-layer W4A8 Qwen3-8B-width target sharded over (1, 2)
against one device: bitwise, both K1 modes and the rotation launched.

Run on the card with ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_mesh_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_cases as C
from repro_torch.launch import mesh as tmesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import _lib

    _lib.lib()  # built once here, before the ranks load it
    return torch.device("cuda")


def test_collectives_on_cuda_tensors(cuda):
    res = tmesh.spawn(C.collectives_case, 1, 2, device="cuda")
    for r in res:
        assert r["device"].startswith("cuda")
        assert r["transport"] == "gloo-shared-card" and r["backend"] == "gloo"
        assert r["sum_model"] == 3 and r["max_all"] == 2 and r["int32_sum"] == 2 ** 29
        assert r["gather_model"] == [1.0, 1.0, 2.0, 2.0]
        assert r["bf16_gather"] == [1.0, 1.0, 2.0, 2.0]
        assert r["int8_a2a"] == [0, 1]
        mi = r["coords"]["model"]
        assert r["a2a_model"] == [[2 * mi, 2 * mi + 1], [2 * mi + 100, 2 * mi + 101]]
        assert r["g_copy"] == [[3.0] * 2] * 2
        assert r["g_rs"] == r["g_split"] == [[1.0] * 3] * 2 + [[2.0] * 3] * 2
        want = 2 * np.arange(12, dtype=np.float32).reshape(4, 3)[2 * mi:2 * mi + 2]
        np.testing.assert_array_equal(np.array(r["g_gather"]), want)


def test_sharded_w4a8_on_the_card_is_one_device(cuda):
    tokens = np.random.RandomState(0).randint(0, 151936, (2, 16))
    res = tmesh.spawn(C.cuda_w4a8_case, 1, 2, device="cuda", args=("qwen3-8b", 2, tokens))
    for r in res:
        assert r["column_bitwise"] and r["row_bitwise"], r
        assert r["forward_bitwise"], r["max_abs"]
        n = r["launches"]
        assert n.get("w4a8_matmul") and n.get("w4a8_matmul_int32"), n
        assert n.get("block_rotate") == 2, n
