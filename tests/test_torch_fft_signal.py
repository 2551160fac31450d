"""The port's convolutions (``tensor/signal/conv.py``), real FFTs
(``tensor/fft.py``) and DFT matrices (``tensor/fourier.py``) against the
JAX package's, on the CPU.

The cases are those of ``tests/test_op_grids_signal_fft.py`` and more:
``Convolve1d`` in each mode, with the second operand longer (numpy swaps
them), an even kernel (numpy's centre for "same"), batched through
``Blockwise`` (one call) and in int64; ``Convolve2d`` in each mode with
an even kernel and swapped operands; the gradients of both in every mode;
``rfft`` and ``irfft`` in float32 and float64 with each ``norm``, an odd
length through ``IRFFTOp(n=)``, the imaginary parts the inverse ignores,
and the gradients.  Each case is built in both packages
(``tests/torch_tail.py``), at its tolerances.
"""

import importlib

import numpy as np
import pytest
import scipy.signal

from tests.torch_tail import check, compile_both, held, run

LENGTHS = [(8, 3), (3, 8), (8, 4), (5, 5), (8, 1), (9, 6)]


# numpy's "same" of a kernel longer than the signal has the kernel's
# length, which the op's static type does not take: not a case
CONV1D_CASES = [(m, na, nb) for m in ("full", "valid", "same") for na, nb in LENGTHS
                if m != "same" or nb <= na]


@pytest.mark.parametrize("mode,na,nb", CONV1D_CASES)
def test_convolve1d_and_its_gradient(mode, na, nb):
    """Static lengths: the "same" gradient needs them, in both packages."""
    def build(ptt, pt):
        a = pt.tensor("a", dtype="float64", shape=(na,))
        b = pt.tensor("b", dtype="float64", shape=(nb,))
        y = pt.signal.convolve1d(a, b, mode=mode)
        return [a, b], [y, *ptt.grad(pt.sum(y ** 2), [a, b])]

    rng = np.random.default_rng(23)
    av, bv = rng.standard_normal(na), rng.standard_normal(nb)
    got = check(build, [av, bv], kind="prod")
    np.testing.assert_allclose(got[0], np.convolve(av, bv, mode), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode", ["full", "valid", "same"])
def test_convolve1d_batched_and_float32(mode):
    """A ``Blockwise`` of ``Convolve1d`` (one grouped convolution in the
    port), a kernel broadcast over the batch, and float32."""
    def build(ptt, pt):
        a, b = pt.dtensor3("a"), pt.dmatrix("b")
        f, g = pt.tensor("f", dtype="float32", shape=(None,)), pt.vector("g", dtype="float32")
        return [a, b, f, g], [pt.signal.convolve1d(a, b, mode=mode),
                              pt.signal.convolve1d(a, b[0], mode=mode),
                              pt.signal.convolve1d(f, g, mode=mode)]

    rng = np.random.default_rng(24)
    check(build, [rng.standard_normal((2, 3, 9)), rng.standard_normal((3, 4)),
                  rng.standard_normal(64).astype("float32"),
                  rng.standard_normal(7).astype("float32")], kind="prod")


@pytest.mark.parametrize("mode", ["full", "valid", "same"])
def test_integer_convolutions_follow_the_oracle(mode):
    """A reference behaviour, not a fault: an int64 convolution is int64 in
    the op's type, the numpy oracle and the port (``unfold``, which torch's
    convolutions do not take); the XLA path gives float64 values
    (``jnp.convolve`` and ``convolve2d`` promote to a float)."""
    def build(ptt, pt):
        i, j, m = pt.lvector("i"), pt.lvector("j"), pt.lmatrix("m")
        return [i, j, m], [pt.signal.convolve1d(i, j, mode=mode),
                           pt.signal.convolve2d(m, m[:2, :3], mode=mode)]

    rng = np.random.default_rng(29)
    vals = [rng.integers(-5, 5, 9), rng.integers(-5, 5, 4), rng.integers(-5, 5, (5, 6))]
    fns = compile_both(build, oracle=True)
    got, oracle, xla = (run(fns[k], vals) for k in ("torch", "oracle", "jax"))
    for g, o, x in zip(got, oracle, xla):
        held(g, o)
        assert str(x.dtype) == "float64"
        np.testing.assert_array_equal(x, o)


@pytest.mark.parametrize("shapes", [((6, 5), (3, 2)), ((3, 2), (6, 5)), ((5, 6), (4, 4)),
                                    ((4, 4), (4, 4))], ids=["6x5,3x2", "3x2,6x5", "5x6,4x4",
                                                            "4x4,4x4"])
@pytest.mark.parametrize("mode", ["full", "valid", "same"])
def test_convolve2d_and_its_gradient(mode, shapes):
    def build(ptt, pt):
        a = pt.tensor("a", dtype="float64", shape=shapes[0])
        b = pt.tensor("b", dtype="float64", shape=shapes[1])
        y = pt.signal.convolve2d(a, b, mode=mode)
        # "same" of a larger kernel: scipy's output has the signal's shape,
        # and the pullback embeds into the full one, which both refuse
        grads = ([] if mode == "same" and shapes[1][0] > shapes[0][0]
                 else list(ptt.grad(pt.sum(y ** 2), [a, b])))
        return [a, b], [y, *grads]

    rng = np.random.default_rng(25)
    av, bv = (rng.standard_normal(s) for s in shapes)
    got = check(build, [av, bv], kind="prod")
    np.testing.assert_allclose(got[0], scipy.signal.convolve2d(av, bv, mode=mode), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("n", [2, 4, 7, 16])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rfft_irfft(dtype, n, norm):
    """The packed half spectrum and its inverse, batched over a leading
    axis; the gradients of both where the JAX package has them (no
    ``norm``)."""
    def build(ptt, pt):
        x = pt.tensor("x", dtype=dtype, shape=(3, n))
        spec = pt.fft.rfft(x, norm=norm)
        outs = [spec, pt.fft.irfft(spec, norm=norm)]
        if norm is None and dtype == "float64":
            w = np.arange(1.0, 3 * (n // 2 + 1) * 2 + 1).reshape(3, n // 2 + 1, 2)
            outs += [ptt.grad(pt.sum(spec * w), x),
                     ptt.grad(pt.sum(pt.fft.irfft(spec) ** 2), x)]
        return [x], outs

    got = check(build, [np.random.default_rng(26).standard_normal((3, n)).astype(dtype)],
                kind="prod")
    assert got[0].shape == (3, n // 2 + 1, 2)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_irfft_of_an_odd_length_and_the_ignored_imaginary_parts(dtype):
    """``IRFFTOp(n=7)`` takes a length the half spectrum does not say; the
    imaginary parts of the first bin (and of the last, for an even length)
    are ignored, as numpy's and XLA's inverses ignore them; an int input
    transforms in float32, as in the JAX package."""
    def build(ptt, pt):
        s = pt.tensor("s", dtype=dtype, shape=(4, 2))
        i = pt.lvector("i")
        return [s, i], [pt.fft.IRFFTOp(n=7)(s), pt.fft.IRFFTOp(n=6)(s), pt.fft.irfft(s),
                        pt.fft.rfft(i)]

    rng = np.random.default_rng(27)
    got = check(build, [rng.standard_normal((4, 2)).astype(dtype), rng.integers(-4, 4, 6)],
                kind="prod")
    assert str(got[3].dtype) == "float32"


def test_fourier_matrices():
    def build(ptt, pt):
        fourier = importlib.import_module(pt.__name__ + ".fourier")
        x = pt.tensor("x", dtype="float64", shape=(8,))
        y = pt.tensor("y", dtype="float32", shape=(2, 5))
        return [x, y], [*fourier.fourier(x), *fourier.fourier(y), *fourier.dft_matrices(4)]

    rng = np.random.default_rng(28)
    xv = rng.standard_normal(8)
    got = check(build, [xv, rng.standard_normal((2, 5)).astype("float32")], kind="prod")
    np.testing.assert_allclose(got[0], np.fft.fft(xv).real, atol=1e-10)
    np.testing.assert_allclose(got[1], np.fft.fft(xv).imag, atol=1e-10)
