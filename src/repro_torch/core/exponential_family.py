"""Exponential-family input distributions for Einsum Networks (paper §3.4).

The whole input layer is one ``D x K x R`` tensor of EF log-densities

    log L = log h(x) + T(x)^T theta - A(theta),

with parameters kept in *expectation form* ``phi`` (Sato, 1999).  Parameter
tensors have shape ``(D, K, R, |T|)``: D variables, K densities per leaf
vector, R replica.

Randomness is explicit: ``init_phi`` takes a ``torch.Generator``, and
``sample`` takes the uniforms it consumes (``noise_per_draw`` of them per
draw, in (0, 1)), so a caller that owns the noise vector decides exactly
which random numbers each draw sees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.layers import gumbel


@dataclasses.dataclass(frozen=True)
class ExponentialFamily:
    """Abstract EF over a single scalar variable (vectorized over leading dims)."""

    name: str = "abstract"

    @property
    def num_stats(self) -> int:
        raise NotImplementedError

    @property
    def noise_per_draw(self) -> int:
        """Uniforms one call of ``sample`` consumes per drawn value."""
        return 1

    def sufficient_statistics(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_h(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def expectation_to_natural(self, phi: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_normalizer(self, theta: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sample(self, phi: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Draws for ``phi`` (..., |T|) from uniforms ``u`` (..., noise_per_draw)."""
        raise NotImplementedError

    def init_phi(self, generator: torch.Generator,
                 shape: Tuple[int, ...]) -> torch.Tensor:
        raise NotImplementedError

    def project_phi(self, phi: torch.Tensor) -> torch.Tensor:
        return phi

    def clamp_fraction(self, phi: torch.Tensor) -> torch.Tensor:
        """Fraction of leaf parameters pinned at their projection bounds (a
        float32 scalar on ``phi``'s device): the health telemetry's detector
        for EM updates that keep hitting ``project_phi``'s clamps.
        Families without hard bounds report 0."""
        return phi.new_zeros((), dtype=torch.float32)

    def mode(self, phi: torch.Tensor) -> torch.Tensor:
        """Distribution mode (deterministic decode for argmax sampling)."""
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        """All-leaves log density tensor (the paper's ``E``).

        Args:
          x:   (B, D) observations.
          phi: (D, K, R, |T|) expectation parameters.

        Returns:
          (B, D, K, R) log-densities.
        """
        theta = self.expectation_to_natural(phi)  # (D, K, R, T)
        return log_density(self.sufficient_statistics(x), self.log_h(x),
                            theta, self.log_normalizer(theta))


def log_density(t: torch.Tensor, log_h: torch.Tensor, theta: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
    """The EF tensor (B, D, K, R) from its parts: log h(x) + T(x)^T theta -
    A(theta), with t (B, D, |T|) and log_h (B, D) of the data, theta (D, K,
    R, |T|) and a (D, K, R).  The leaf-rows kernel
    (``kernels/csrc/leaf_rows.cu``) rounds each term as this does."""
    # T(x)^T theta as elementwise products summed in a fixed order: a
    # contraction routed through a GEMM could round a row differently
    # depending on how many rows share the call
    dot = t[:, :, None, None, 0] * theta[None, ..., 0]
    for i in range(1, theta.shape[-1]):
        dot = dot + t[:, :, None, None, i] * theta[None, ..., i]
    return log_h[:, :, None, None] + dot - a[None]


class Normal(ExponentialFamily):
    """Univariate Gaussian.  T(x) = [x, x^2], phi = [mu, mu^2 + sigma^2]."""

    def __init__(self, min_var: float = 1e-6, max_var: float = 10.0):
        object.__setattr__(self, "name", "normal")
        object.__setattr__(self, "min_var", float(min_var))
        object.__setattr__(self, "max_var", float(max_var))

    @property
    def num_stats(self) -> int:
        return 2

    def sufficient_statistics(self, x):
        return torch.stack([x, x * x], dim=-1)

    def log_h(self, x):
        c = -0.5 * torch.log(torch.tensor(2.0 * math.pi, dtype=x.dtype))
        return torch.full(x.shape, float(c), dtype=x.dtype, device=x.device)

    def _moments(self, phi):
        mu = phi[..., 0]
        var = torch.clamp(phi[..., 1] - mu * mu, self.min_var, self.max_var)
        return mu, var

    def expectation_to_natural(self, phi):
        mu, var = self._moments(phi)
        return torch.stack([mu / var, -0.5 / var], dim=-1)

    def log_normalizer(self, theta):
        return -(theta[..., 0] ** 2) / (4.0 * theta[..., 1]) - 0.5 * torch.log(
            -2.0 * theta[..., 1]
        )

    def sample(self, phi, u):
        mu, var = self._moments(phi)
        return mu + torch.sqrt(var) * torch.special.ndtri(u[..., 0])

    def init_phi(self, generator, shape):
        mu = torch.randn(shape, generator=generator) * 0.5
        var = torch.ones(shape)
        return torch.stack([mu, mu * mu + var], dim=-1)

    def mode(self, phi):
        return phi[..., 0]

    def project_phi(self, phi):
        mu, var = self._moments(phi)
        return torch.stack([mu, mu * mu + var], dim=-1)

    def clamp_fraction(self, phi):
        mu = phi[..., 0]
        raw_var = phi[..., 1] - mu * mu
        pinned = (raw_var <= self.min_var) | (raw_var >= self.max_var)
        return torch.mean(pinned.to(torch.float32))


class Bernoulli(ExponentialFamily):
    """x in {0,1}.  T(x) = [x], phi = [p]."""

    def __init__(self, min_p: float = 1e-6):
        object.__setattr__(self, "name", "bernoulli")
        object.__setattr__(self, "min_p", float(min_p))

    @property
    def num_stats(self) -> int:
        return 1

    def sufficient_statistics(self, x):
        return x[..., None]

    def log_h(self, x):
        return torch.zeros_like(x)

    def _p(self, phi):
        return torch.clamp(phi[..., 0], self.min_p, 1.0 - self.min_p)

    def expectation_to_natural(self, phi):
        p = self._p(phi)
        return torch.log(p / (1.0 - p))[..., None]

    def log_normalizer(self, theta):
        return torch.logaddexp(torch.zeros_like(theta[..., 0]), theta[..., 0])

    def sample(self, phi, u):
        return (u[..., 0] < self._p(phi)).to(torch.float32)

    def init_phi(self, generator, shape):
        return 0.3 + 0.4 * torch.rand(shape + (1,), generator=generator)

    def mode(self, phi):
        return (self._p(phi) > 0.5).to(torch.float32)

    def project_phi(self, phi):
        return torch.clamp(phi, self.min_p, 1.0 - self.min_p)

    def clamp_fraction(self, phi):
        p = phi[..., 0]
        pinned = (p <= self.min_p) | (p >= 1.0 - self.min_p)
        return torch.mean(pinned.to(torch.float32))


class Binomial(ExponentialFamily):
    """x in {0..N}: T(x) = [x], phi = [N p], log h(x) = log C(N, x)."""

    def __init__(self, n_trials: int, min_p: float = 1e-6):
        object.__setattr__(self, "name", "binomial")
        object.__setattr__(self, "n_trials", int(n_trials))
        object.__setattr__(self, "min_p", float(min_p))
        # log N! once, in float32 on the CPU, kept as a Python float: no
        # device tensor is built a call (a host copy would break a CUDA
        # graph's capture), and the value is the float32 lgamma's
        object.__setattr__(self, "log_n_factorial", float(torch.lgamma(
            torch.tensor(float(n_trials + 1), dtype=torch.float32))))

    @property
    def num_stats(self) -> int:
        return 1

    @property
    def noise_per_draw(self) -> int:
        return self.n_trials

    def sufficient_statistics(self, x):
        return x[..., None]

    def log_h(self, x):
        n = self.n_trials
        return (
            self.log_n_factorial
            - torch.lgamma(x + 1.0)
            - torch.lgamma(n - x + 1.0)
        )

    def _p(self, phi):
        return torch.clamp(phi[..., 0] / self.n_trials, self.min_p,
                           1.0 - self.min_p)

    def expectation_to_natural(self, phi):
        p = self._p(phi)
        return torch.log(p / (1.0 - p))[..., None]

    def log_normalizer(self, theta):
        t = theta[..., 0]
        return self.n_trials * torch.logaddexp(torch.zeros_like(t), t)

    def sample(self, phi, u):
        p = self._p(phi)
        return torch.sum(u < p[..., None], dim=-1).to(torch.float32)

    def init_phi(self, generator, shape):
        p = 0.3 + 0.4 * torch.rand(shape + (1,), generator=generator)
        return p * self.n_trials

    def mode(self, phi):
        return torch.round(torch.clamp(phi[..., 0], 0, self.n_trials))

    def project_phi(self, phi):
        return torch.clamp(phi, self.min_p * self.n_trials,
                           (1.0 - self.min_p) * self.n_trials)

    def clamp_fraction(self, phi):
        p = phi[..., 0] / self.n_trials
        pinned = (p <= self.min_p) | (p >= 1.0 - self.min_p)
        return torch.mean(pinned.to(torch.float32))


class Categorical(ExponentialFamily):
    """x in {0..C-1}.  T(x) = onehot(x), phi = probs (C,)."""

    def __init__(self, num_categories: int, min_p: float = 1e-6):
        object.__setattr__(self, "name", "categorical")
        object.__setattr__(self, "num_categories", int(num_categories))
        object.__setattr__(self, "min_p", float(min_p))

    @property
    def num_stats(self) -> int:
        return self.num_categories

    @property
    def noise_per_draw(self) -> int:
        return self.num_categories

    def sufficient_statistics(self, x):
        return torch.nn.functional.one_hot(
            x.to(torch.int64), self.num_categories).to(torch.float32)

    def log_h(self, x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    def _p(self, phi):
        p = torch.clamp(phi, self.min_p, 1.0)
        return p / torch.sum(p, dim=-1, keepdim=True)

    def expectation_to_natural(self, phi):
        return torch.log(self._p(phi))

    def log_normalizer(self, theta):
        return torch.zeros(theta.shape[:-1], dtype=theta.dtype,
                           device=theta.device)

    def sample(self, phi, u):
        logits = torch.log(self._p(phi))
        return torch.argmax(logits + gumbel(u), dim=-1).to(torch.float32)

    def init_phi(self, generator, shape):
        p = 0.5 + torch.rand(shape + (self.num_categories,), generator=generator)
        return p / torch.sum(p, dim=-1, keepdim=True)

    def mode(self, phi):
        return torch.argmax(phi, dim=-1).to(torch.float32)

    def project_phi(self, phi):
        return self._p(phi)

    def clamp_fraction(self, phi):
        return torch.mean((phi <= self.min_p).to(torch.float32))


EF_REGISTRY = {
    "normal": Normal,
    "bernoulli": Bernoulli,
    "binomial": Binomial,
    "categorical": Categorical,
}


def make_exponential_family(name: str, **kwargs) -> ExponentialFamily:
    return EF_REGISTRY[name](**kwargs)
