"""What the CPU tests of the example twins share
(``test_torch_examples_amp.py``, ``test_torch_examples_cluster.py``): the
numpy problem both packages are given, and the two ways a twin's solve is
held against the reference's (the tests' module docstrings say why)."""
import numpy as np

import repro.core.denoisers as jd
import repro.core.state_evolution as jse


LOSSLESS_RTOL = 1e-5


def draw(seed, n, m, eps, snr_db=20.0):
    """(s0, A, y) of the paper's model with numpy, float32."""
    prob = jse.CSProblem(n=n, m=m, prior=jd.BernoulliGauss(eps=eps),
                         snr_db=snr_db)
    rng = np.random.default_rng(seed)
    s0 = ((rng.random(n) < eps) * rng.normal(size=n)).astype(np.float32)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)
         ).astype(np.float32)
    return s0, a, y


def lossless_close(got_x, want_x, got_mse, want_mse):
    got_x, want_x = np.asarray(got_x), np.asarray(want_x)
    assert np.abs(got_x - want_x).max() <= \
        LOSSLESS_RTOL * np.abs(want_x).max()
    np.testing.assert_allclose(got_mse, want_mse, rtol=LOSSLESS_RTOL)


def statistically_close(got_mse, want_mse, got_d, want_d, got_s2=None,
                        want_s2=None):
    """A BT- or DP-rated solve against the reference's (module docstring):
    the first bin (both runs start from the same lossless iterate) within
    1e-4, the final MSE within 1 dB, ``sigma2_hat`` within 10 %. Later bins
    are not compared one by one: a BT bin is a steep function of the
    plug-in (the reference's own moves by 2.6e-4 for a 2.4e-5 change of
    sigma2_hat at wire_demo's smoke point), so once the runs part a bin
    can move by tens of per cent while the totals stay within 5 %."""
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    np.testing.assert_array_equal(np.isfinite(got_d), np.isfinite(want_d))
    if np.isfinite(want_d[0]):
        np.testing.assert_allclose(got_d[0], want_d[0], rtol=1e-4)
    assert abs(10 * np.log10(got_mse[-1] / want_mse[-1])) < 1.0
    if want_s2 is not None:
        np.testing.assert_allclose(got_s2, want_s2, rtol=0.10)


