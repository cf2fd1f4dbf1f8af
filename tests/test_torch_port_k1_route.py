"""K1's choice between its two CUDA designs, checked on the CPU.

``k1_route`` is a pure function of (slices, tq, tk, d, dtype): the Hopper
design takes d = 64 in 16-bit types with at most 768 keys (the band route
when tq and tk both fit one 64-row tile, the time route otherwise), and the
PR-1 core takes every other shape.  A CPU tensor takes the plain version
whatever the route and counts no launch.
"""

import numpy as np
import pytest
import torch

from audiolab_tpu_torch.kernels import attention as TA

BF, F16 = torch.bfloat16, torch.float16


@pytest.mark.parametrize("bh,tq,tk,d,dtype,route", [
    (3968, 690, 690, 64, BF, "time"),     # RoFormer time axis (main path)
    (44160, 62, 62, 64, BF, "band"),      # RoFormer band axis (main path)
    (3968, 690, 690, 64, F16, "time"),
    (44160, 62, 62, 64, F16, "band"),
    (8, 64, 64, 64, BF, "band"),          # one whole tile and chunk
    (8, 65, 64, 64, BF, "time"),          # a second query tile
    (8, 64, 65, 64, BF, "time"),          # a second key chunk
    (8, 1, 1, 64, BF, "band"),
    (8, 100, 768, 64, BF, "time"),        # the most keys kept resident
    (8, 100, 769, 64, BF, "core"),
    (8, 70, 1000, 64, BF, "core"),
    (8, 62, 62, 32, BF, "core"),          # other head dims
    (8, 690, 690, 128, BF, "core"),
    (8, 62, 62, 16, F16, "core"),
    (8, 62, 62, 64, torch.float32, "core"),
])
def test_k1_route(bh, tq, tk, d, dtype, route):
    assert TA.k1_route(bh, tq, tk, d, dtype) == route


def test_k1_route_ignores_the_slice_count():
    assert {TA.k1_route(bh, 62, 62, 64, BF) for bh in (1, 131, 132, 133, 44160)} == {"band"}
    assert {TA.k1_route(bh, 690, 690, 64, BF) for bh in (1, 132, 3968)} == {"time"}


@pytest.mark.parametrize("tq,tk", [(62, 62), (100, 62), (62, 690)])
def test_cpu_tensors_take_the_plain_version_on_every_route(tq, tk):
    rng = np.random.default_rng(tq + tk)

    def t(n):
        return torch.from_numpy(rng.standard_normal((1, 2, n, 64)).astype(np.float32)).to(BF)

    TA.reset_launch_counts()
    q, k, v = t(tq), t(tk), t(tk)
    ref = TA.attention_nk1_reference(q, k, v, 0.125)
    assert torch.equal(TA.attention_nk1(q, k, v), ref)
    assert torch.equal(TA.attention_nk1_core(q, k, v), ref)
    assert (TA.attention_nk1.launches, TA.attention_nk1.sm90_launches,
            TA.attention_nk1_core.launches) == (0, 0, 0)
