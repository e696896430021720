"""Every family's step over two gloo ranks (pod=2, data=1, model=1;
``tests/torch_train.py::zoo_cases``, spawned processes on the CPU): the
exact step, the same step donated (in place, with ZeRO-1 over the two
ranks: each updates its slice and all-gathers), and the int8 compressed
fusion over "pod" donated, one step each from the seed-0 init, with
``moe_groups=2`` and the stub inputs of the global batch (each rank takes
its rows).

  * the donated step gives the functional one's bits (parameters, master,
    m, v), on both ranks;
  * both ranks hold the same parameters after each step;
  * int8: the loss is the exact step's (the loss is averaged exactly, 1e-6
    relative); the parameters move from the exact step's by at most what a
    flipped AdamW first step can do (2 lr, plus a bf16 ulp: the first step
    moves every weight by about +-lr whatever its gradient's size), and
    some do move; the quantization noise is positive; the "pod" axis
    carried only uint8 in its all-to-all and all-gather.
"""
import numpy as np
import pytest

import torch_spmd
import torch_train

LR = 3e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_spmd.run_world(torch_train.zoo_cases, 2,
                                tmp_path_factory.mktemp("zoo_world"),
                                torch_train.ZOO_ARCHS)


@pytest.mark.parametrize("arch", torch_train.ZOO_ARCHS)
def test_compressed_and_donated_steps_on_two_ranks(ranks, arch):
    r0, r1 = (r[arch] for r in ranks)
    for r in (r0, r1):
        ex, don, q = r["exact"], r["exact_donated"], r["int8"]
        assert ex["loss"] == don["loss"]
        for k in ex["bits"]:
            np.testing.assert_array_equal(don["bits"][k], ex["bits"][k])
        for key in ("master", "m", "v"):
            for k in ex["opt_bits"][key]:
                np.testing.assert_array_equal(don["opt_bits"][key][k],
                                              ex["opt_bits"][key][k])
        assert np.isfinite(q["loss"])
        assert abs(q["loss"] - ex["loss"]) <= 1e-6 * abs(ex["loss"])
        moved = False
        for k, want in ex["params"].items():
            d = np.abs(q["params"][k] - want)
            assert np.all(d <= 2 * LR * (1 + 1e-3)
                          + 2.0 ** -7 * np.abs(want)), k
            moved |= bool(d.max() > 0)
        assert moved
        assert q["quant_noise"] > 0
        pod = q["pod"]["bytes"]
        assert set(pod["all_to_all"]) == {"uint8"}, pod
        assert set(pod["all_gather"]) == {"uint8"}, pod
    for name in ("exact", "exact_donated", "int8"):
        for k in r0[name]["bits"]:
            np.testing.assert_array_equal(r0[name]["bits"][k],
                                          r1[name]["bits"][k])
