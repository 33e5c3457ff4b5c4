"""The SIREN configuration: the program's entry points for each loop, and
the control that stands in for them.

Program side: ``compile_gradient`` and ``CompiledGradient.apply_batched``
(closed loop), ``compile_fit`` with ``LaplacianMSE`` and the
program's AdamW (fit).  Control side: the plain reference in float32 with
TF32 products, put in the program's place behind the same methods.
"""

from __future__ import annotations

import torch

from inrbench.reference import fit as ref_fit
from inrbench.reference import siren as ref
from inrbench.tf32 import tf32_allowed, tf32_matmul


def sine_layers(config) -> int:
    """SIREN counts its hidden layers after the first sine layer (its
    released ``Siren(hidden_layers=3)`` has four); the program counts every
    sine layer."""
    return config["hidden_layers"] + 1


def sizes(config) -> list[int]:
    return ([config["in_features"]]
            + [config["hidden_features"]] * sine_layers(config)
            + [config["out_features"]])


def weights(config, gen, device, n: int = 1):
    """``n`` weight sets, made on ``device`` from ``gen``."""
    return [ref.init(sizes(config), config["w0"], gen, device)
            for _ in range(n)]


def _siren_cfg(config):
    from repro_torch.configs.siren import SirenConfig
    return SirenConfig(in_features=config["in_features"],
                       out_features=config["out_features"],
                       hidden_features=config["hidden_features"],
                       hidden_layers=sine_layers(config),
                       w0=config["w0"])


def _fn(config, params):
    from repro_torch.inr.siren import siren_fn
    return siren_fn(_siren_cfg(config), params)


def _example(config, device):
    return torch.zeros(64, config["in_features"], device=device)


# -- closed loop ------------------------------------------------------------

class ClosedProgram:
    """One compiled artifact serving whole requests (``apply_batched``)."""

    def __init__(self, config, traffic, params, device):
        from repro_torch.core.pipeline import compile_gradient
        self.order = traffic["order"]
        self.cg = compile_gradient(_fn(config, params), self.order,
                                   _example(config, device), device=device)

    def serve(self, coords):
        return self.cg.apply_batched(coords)


class ClosedControl:
    """The reference in the program's place, in float32 with TF32."""

    def __init__(self, config, traffic, params, device):
        self.order, self.w0, self.params = (traffic["order"], config["w0"],
                                            params)

    def serve(self, coords):
        return ref.outputs(self.params, coords, self.order, self.w0,
                           tf32_matmul)


def closed_reference(config, traffic, params, coords):
    """Float64 outputs for ``coords``."""
    return ref.outputs(ref.as_dtype(params, torch.float64),
                       coords.double(), traffic["order"], config["w0"])


# -- fit --------------------------------------------------------------------

def fit_target(config, teacher, coords):
    """The supervision: the teacher's Laplacian by the float64 reference,
    as float32 ``[N, C]``."""
    return ref.laplacian(ref.as_dtype(teacher, torch.float64),
                         coords.double(), config["w0"]).float()


def _adamw(traffic):
    from repro_torch.optim.adam import AdamWConfig
    return AdamWConfig(**traffic["adamw"])


class FitProgram:
    """One training object: the compiled fit, the weights and AdamW's
    state.  ``step`` is one ``value_and_grad`` over the whole grid and one
    ``adamw_update``, the body of the program's ``fit`` loop, with the
    optimizer state kept across calls."""

    def __init__(self, config, traffic, params, coords, target, device):
        from repro_torch.core.pipeline import compile_fit
        from repro_torch.fit.objectives import LaplacianMSE
        from repro_torch.optim.adam import init_opt_state
        self.cf = compile_fit(_fn(config, params), LaplacianMSE(),
                              traffic["order"], _example(config, device),
                              params=params, device=device)
        self.coords, self.target = coords, target
        self.adam = _adamw(traffic)
        self.leaves = list(self.cf.leaves_of(params))
        self.opt = init_opt_state(self.leaves)
        self.i = 0

    def step(self) -> float:
        from repro_torch.optim.adam import adamw_update
        loss, grads = self.cf.value_and_grad(self.cf.unflatten(self.leaves),
                                             self.coords, self.target)
        gl = list(self.cf.leaves_of(grads))
        self.leaves, self.opt, _ = adamw_update(self.adam, self.leaves, gl,
                                                self.opt, self.i)
        self.i += 1
        return float(loss)

    def leaves_now(self) -> list:
        """Weights as the reference orders them (layer, then b, w)."""
        return [v.detach().clone() for v in self.leaves]

    def first_moments(self) -> list:
        return [m.detach().clone() for m in self.opt["mu"]]


class FitControl:
    """The reference's fit in float32 with TF32 products, with the
    program's state layout."""

    def __init__(self, config, traffic, params, coords, target, device):
        self.w0, self.cfg = config["w0"], dict(traffic["adamw"])
        self.coords, self.target = coords, target
        self.leaves = [v.detach() for v in ref_fit.flat(params)]
        self.mu = [torch.zeros_like(v) for v in self.leaves]
        self.nu = [torch.zeros_like(v) for v in self.leaves]
        self.i = 0

    def step(self) -> float:
        with tf32_allowed():
            loss, grads = ref_fit.loss_and_grads(
                ref_fit.unflat(self.leaves), self.coords, self.target,
                self.w0, matmul=tf32_matmul)
        self.leaves, self.mu, self.nu = ref_fit.adamw(
            self.cfg, self.leaves, grads, self.mu, self.nu, self.i)
        self.i += 1
        return float(loss)

    def leaves_now(self) -> list:
        return [v.detach().clone() for v in self.leaves]

    def first_moments(self) -> list:
        return [m.detach().clone() for m in self.mu]


def fit_reference(config, traffic, params, coords, target, steps: int):
    return ref_fit.run(ref.as_dtype(params, torch.float64), coords.double(),
                       target.double(), config["w0"], traffic["adamw"],
                       steps)
