"""Experiment-level config dataclasses and the CLI's name registries.

Counterpart of ``cglb_tpu/configs.py`` (numpy only, but not importable
without jax): frozen dataclasses for kernels, models and inducing
variables; ``params(data)`` returns the reference defaults (variance 1, ARD
lengthscales 1, noise 1).  Every name of the JAX CLI parses; the backend
raises for the model kinds not ported yet.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict

import numpy as np

__all__ = ["KernelConfig", "SquaredExponentialConfig", "Matern32Config",
           "InducingVariableConfig", "ModelConfig", "GPRConfig",
           "ExactGPConfig", "SGPRConfig", "CGLBConfig", "CGLBN2MConfig",
           "CGLBNM2Config", "SGPRN2MConfig", "GPR_CONFIGS", "SGPR_CONFIGS",
           "KERNEL_CONFIGS", "INDUCING_VARIABLE_CONFIGS"]

_frozen = partial(dataclasses.dataclass, frozen=True)


class Config:
    def params(self, data) -> Dict:
        return {}


@_frozen
class ModelConfig(Config):
    pass


class KernelConfig(Config):
    pass


@_frozen
class SquaredExponentialConfig(KernelConfig):
    def params(self, data) -> Dict:
        return {"variance": 1.0,
                "lengthscales": np.repeat(1.0, data[0].shape[-1])}


@_frozen
class Matern32Config(SquaredExponentialConfig):
    pass


@_frozen
class InducingVariableConfig(Config):
    """Greedy ConditionalVariance selection of M inducing points, on the
    device of the data (utils/inducing.py)."""

    num_variables: int

    def init(self, data, kernel, seed: int = 0):
        from .utils.inducing import conditional_variance

        Z, _ = conditional_variance(data[0], self.num_variables, kernel,
                                    seed=seed)
        return Z


@_frozen
class GPRConfig(ModelConfig):
    kernel: KernelConfig

    def params(self, data) -> Dict:
        return {"noise_variance": 1.0}


@_frozen
class ExactGPConfig(GPRConfig):
    pass


@_frozen
class SGPRConfig(ModelConfig):
    kernel: KernelConfig
    inducing_variable: InducingVariableConfig

    def params(self, data) -> Dict:
        return {"noise_variance": 1.0,
                "inducing_variable": partial(self.inducing_variable.init,
                                             data)}


@_frozen
class CGLBConfig(SGPRConfig):
    max_error: float = 1.0
    joint_optimization: bool = False
    vzero: bool = False

    def params(self, data) -> Dict:
        d = super().params(data)
        d.update(max_error=self.max_error,
                 joint_optimization=self.joint_optimization,
                 vzero=self.vzero)
        return d


@_frozen
class CGLBN2MConfig(CGLBConfig):
    pass


@_frozen
class CGLBNM2Config(CGLBConfig):
    pass


@_frozen
class SGPRN2MConfig(SGPRConfig):
    pass


GPR_CONFIGS = {"gpr": GPRConfig, "exactgp": ExactGPConfig}

SGPR_CONFIGS = {
    "sgpr": SGPRConfig,
    "cglb": CGLBConfig,
    "sgprn2m": SGPRN2MConfig,
    "cglbn2m": CGLBN2MConfig,
    "cglbnm2": CGLBNM2Config,
}

KERNEL_CONFIGS = {
    "SquaredExponential": SquaredExponentialConfig,
    "Matern32": Matern32Config,
    "mat32": Matern32Config,
    "rbf": SquaredExponentialConfig,
}

INDUCING_VARIABLE_CONFIGS = {
    "InducingVariable": InducingVariableConfig,
    "ConditionalVariance": InducingVariableConfig,
    "iv": InducingVariableConfig,
    "cv": InducingVariableConfig,
}
