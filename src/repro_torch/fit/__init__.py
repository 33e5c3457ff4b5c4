"""Streamed INR fitting (port of ``repro.fit``, DESIGN.md §11):
``compile_fit`` builds a cached ``CompiledFit`` over the serving block
pipeline; ``fit`` / ``fit_many`` drive it through AdamW and stream fitted
weights into the store."""

from repro_torch.fit.compile import CompiledFit, compile_fit
from repro_torch.fit.engine import FitResult, fit, fit_many
from repro_torch.fit.objectives import (GradMSE, LaplacianMSE, Objective,
                                        ValueMSE)

__all__ = ["CompiledFit", "compile_fit", "FitResult", "fit", "fit_many",
           "Objective", "ValueMSE", "GradMSE", "LaplacianMSE"]
