"""The port's async front end on the card, over an engine built with the
index-less device ``"cuda"`` (the default of ``python -m
repro_torch.serving.server`` and of ``Engine``).

The engine resolves that device to the calling thread's current CUDA
device when it is built (``engine.resolve_device``), and the AsyncEngine's
worker makes that index current before it steps the engine.  Each stream
must equal ``Engine.run`` of the same request on a synchronous engine of
the same pair; the pages return when the streams finish.  The quantized
smoke pair runs every main-path kernel (W4A8, the rotation, BVQ, paged
attention).  Tolerance: none.  The card only: imports no JAX, and skips
where there is no card."""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch.serve import build_pair  # noqa: E402
from repro_torch.serving.async_engine import AsyncEngine  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig, SamplingParams  # noqa: E402


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_async_engine_over_indexless_cuda_device(cuda):
    target, draft = build_pair(seed=0, s_max=128, quantize=True, device="cuda")
    cfg = EngineConfig(max_batch=2, page_size=8)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 512, size=n).astype(np.int32) for n in (5, 9, 4)]
    sps = [SamplingParams(max_tokens=12), SamplingParams(temperature=0.8, seed=7, max_tokens=12),
           SamplingParams(max_tokens=8)]
    outs, _ = Engine(target, draft, cfg, device="cuda").run(prompts, sps)
    want = [[int(t) for t in o] for o in outs]

    eng = Engine(target, draft, cfg, device="cuda")
    assert eng.device == torch.device("cuda", torch.cuda.current_device())

    async def consume(aeng, i):
        await asyncio.sleep(0.02 * i)
        toks = []
        async for out in aeng.generate(prompts[i], sps[i]):
            toks.extend(int(t) for t in out.new_token_ids)
        return toks

    async def scenario():
        async with AsyncEngine(eng, max_queued=4) as aeng:
            return await asyncio.gather(*[consume(aeng, i) for i in range(len(prompts))])

    _lib.launches.clear()
    got = asyncio.run(scenario())
    assert got == want
    assert all(_lib.launches[k] > 0 for k in ("w4a8_matmul", "block_rotate", "bvq_matmul",
                                              "paged_attention")), dict(_lib.launches)
    t_stats, d_stats = eng.pool_stats()
    assert t_stats.used_pages == 0 and d_stats.used_pages == 0
