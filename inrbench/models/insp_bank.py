"""The INSP bank configuration: INSP-Net heads over the SIREN's gradient
features, compiled as one bank (``compile_bank``) and served whole
(``CompiledBank.apply_batched``), and the control that stands in for it."""

from __future__ import annotations

import torch

from inrbench.models import siren
from inrbench.reference import insp as ref
from inrbench.reference import siren as ref_siren
from inrbench.tf32 import tf32_matmul


def head_sizes(config) -> list[int]:
    order, D, C = config["order"], config["in_features"], \
        config["out_features"]
    n_feat = C * sum(D ** k for k in range(order + 1))
    return ([n_feat] + [config["head_hidden"]] * (config["head_layers"] - 1)
            + [config["head_out"]])


def weights(config, gen, device, n: int = 1):
    """``n`` sets of (SIREN weights, heads), made on ``device``."""
    return [(siren.weights(config, gen, device)[0],
             ref.init(head_sizes(config), config["heads"], gen, device))
            for _ in range(n)]


class ClosedProgram:
    def __init__(self, config, traffic, params, device):
        from repro_torch.core.pipeline import compile_bank
        from repro_torch.inr.insp import insp_head
        if traffic["order"] != config["order"]:
            raise ValueError(f"the bank serves order {config['order']}, "
                             f"the traffic asks for {traffic['order']}")
        inr, heads = params
        self.bank = compile_bank(siren._fn(config, inr),
                                 [insp_head(psi) for psi in heads],
                                 config["order"],
                                 siren._example(config, device),
                                 device=device)

    def serve(self, coords):
        return self.bank.apply_batched(coords)


class ClosedControl:
    def __init__(self, config, traffic, params, device):
        self.config, self.params = config, params

    def serve(self, coords):
        inr, heads = self.params
        return ref.outputs(inr, heads, coords, self.config["order"],
                           self.config["w0"], tf32_matmul)


def closed_reference(config, traffic, params, coords):
    inr, heads = params
    heads64 = [ref_siren.as_dtype(psi, torch.float64) for psi in heads]
    return ref.outputs(ref_siren.as_dtype(inr, torch.float64), heads64,
                       coords.double(), config["order"], config["w0"])
