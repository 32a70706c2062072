"""The port's activations (``repro_torch.models.layers.silu`` / ``gelu``)
against ``jax.nn.silu`` / ``jax.nn.gelu``, forward and backward, on the CPU.

bf16: every finite bf16 input, bit for bit against JAX compiled with
``xla_allow_excess_precision`` off (JAX's op-by-op bits, as the LM parity
tests compile it).  XLA on the CPU flushes float32 denormals to zero at
every step and the port does not (ROADMAP Queue 3, divergences by design),
so an input is held where no step of the chain reaches them: the input is
zero or normal, both results are normal (or both zero, or both NaN where
``x * x`` overflows), and silu's ``g * sigmoid(x)`` is not a denormal:
64,767 to 65,026 of the 65,280 inputs, by check.  The inputs left out are
counted and must lie where a flush can act.

float32: torch's ``sigmoid`` / ``gelu``, held to JAX within 1e-5 x max
|out|, as the GNN tests hold float32.  Measured on the test's 65,536 draws:
forward 2.1e-9 (silu) and 8.5e-9 (gelu), gradients 1.1e-7 and 3.4e-6,
x max |out|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro_torch.models import layers as L

BF16 = torch.bfloat16
TINY = 2.0 ** -126       # float32's (and bf16's) smallest normal
JAX_FN = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}
PORT_FN = {"silu": L.silu, "gelu": L.gelu}


def xla(fn, *args):
    """``fn`` compiled by XLA with ``xla_allow_excess_precision`` off."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})


def all_finite_bf16() -> torch.Tensor:
    bits = np.arange(1 << 16, dtype=np.uint16).view(np.int16)
    x = torch.from_numpy(bits.copy()).view(BF16)
    return x[torch.isfinite(x)]


def random_cotangent(n: int, seed: int = 0) -> torch.Tensor:
    """bf16 cotangents of random sign and magnitude 2^-8 .. 2^8."""
    rng = np.random.default_rng(seed)
    mag = 2.0 ** rng.uniform(-8.0, 8.0, n)
    return torch.from_numpy(np.where(rng.random(n) < 0.5, -mag, mag).astype(np.float32)).to(BF16)


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == BF16 else jnp.float32)


def from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


@pytest.fixture(scope="module")
def inputs():
    x = all_finite_bf16()
    assert x.numel() == 65280
    g = random_cotangent(x.numel())
    return x, g


def sigmoid_product_flushes(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Where ``g * sigmoid(x)`` (silu's backward) is a nonzero float32
    denormal, which XLA flushes to zero."""
    p = (g.double() * torch.sigmoid(x.double()).to(BF16).double()).abs()
    return (p > 0) & (p < TINY)


def held(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The inputs where neither the input nor a result is a denormal (see
    the module docstring)."""
    normal = lambda v: v.abs() >= TINY
    xf = x.float()
    nan = torch.isnan(got) & torch.isnan(want)
    return ((xf == 0) | normal(xf)) & (
        (normal(got) & normal(want)) | ((got == 0) & (want == 0)) | nan)


def assert_bits(name: str, x, got, want, flushed=None):
    got = got.float()
    keep = held(x, got, want)
    if flushed is not None:
        keep &= ~flushed
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    bad = keep & ~same
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} inputs differ, e.g. x = {x[bad][:4].float().tolist()}, "
        f"port {got[bad][:4].tolist()}, JAX {want[bad][:4].tolist()}")
    # what is left out lies where XLA flushes: a denormal-sized input or
    # result, or a sigmoid below float32's normals (x < -80)
    out = ~keep
    xf = x.float()
    assert int(out.sum()) <= 600, (name, int(out.sum()))
    assert bool(((xf[out].abs() < 2.0 ** -100) | (xf[out] < -80)).all()), \
        (name, xf[out][(xf[out].abs() >= 2.0 ** -100) & (xf[out] >= -80)][:4].tolist())


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_bf16_forward_bitwise_equal_to_jax(inputs, name):
    x, _ = inputs
    xj = to_jax(x)
    want = from_jax(xla(JAX_FN[name], xj)(xj))
    got = PORT_FN[name](x)
    assert got.dtype == BF16 and got.shape == x.shape
    assert_bits(f"{name} forward", x, got, want)


@pytest.mark.parametrize("cotangent", ["ones", "random"])
@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_bf16_grad_bitwise_equal_to_jax(inputs, name, cotangent):
    """``jax.vmap(jax.grad(f))`` for a unit cotangent, ``jax.vjp`` for a
    random one, against the port's backward through autograd."""
    x, g = inputs
    if cotangent == "ones":
        g = torch.ones_like(x)
        xj = to_jax(x)
        want = from_jax(xla(jax.vmap(jax.grad(JAX_FN[name])), xj)(xj))
    else:
        xj, gj = to_jax(x), to_jax(g)
        want = from_jax(xla(lambda x, g: jax.vjp(JAX_FN[name], x)[1](g)[0], xj, gj)(xj, gj))
    xr = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(PORT_FN[name](xr), xr, g)
    assert got.dtype == BF16
    flushed = sigmoid_product_flushes(x, g) if name == "silu" else None
    assert_bits(f"{name} grad ({cotangent})", x, got, want, flushed)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_float32_close_to_jax(name):
    rng = np.random.default_rng(1)
    scales = np.repeat(np.float32([0.01, 1.0, 4.0, 30.0]), 1 << 14)
    x = (rng.normal(size=scales.size) * scales).astype(np.float32)
    xj = jnp.asarray(x)
    want = np.asarray(xla(JAX_FN[name], xj)(xj))
    want_g = np.asarray(xla(jax.vmap(jax.grad(JAX_FN[name])), xj)(xj))
    xr = torch.from_numpy(x).requires_grad_()
    y = PORT_FN[name](xr)
    (grad,) = torch.autograd.grad(y, xr, torch.ones_like(y))
    assert y.dtype == grad.dtype == torch.float32
    for what, got, ref in (("forward", y.detach().numpy(), want),
                           ("grad", grad.numpy(), want_g)):
        err = float(np.abs(got - ref).max())
        assert err <= 1e-5 * float(np.abs(ref).max()), (name, what, err)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_bf16_activations_run_on_meta(name):
    """The dry run counts the activations' operations on ``meta``."""
    x = torch.empty(4, 8, dtype=BF16, device="meta", requires_grad=True)
    y = PORT_FN[name](x)
    (g,) = torch.autograd.grad(y, x, torch.empty_like(y))
    assert y.device.type == g.device.type == "meta"
    assert y.shape == g.shape == x.shape and y.dtype == g.dtype == BF16
