"""autobzcore_tpu: Brillouin-zone integration & Wannier interpolation in JAX.

A from-scratch JAX/XLA framework with the capabilities of AutoBZCore.jl
(reference layout documented in SURVEY.md): a SciML-style problem/solver
interface, adaptive and fixed quadratures re-expressed as fixed-shape XLA
programs, symmetry-reduced periodic trapezoidal rules, iterated adaptive
integration with amortized Fourier-series contraction, and a DOS problem
family with the Gilat-Raubenheimer method on batched eigendecompositions.
"""
import jax as _jax

# double precision by default: BZ integration routinely targets 1e-6..1e-10
# tolerances; users can opt into f32/bf16 per-series via the dtype arguments.
_jax.config.update("jax_enable_x64", True)

from .domains import Basis, HyperCube, PuncturedInterval
from .interfaces import (
    IntegralCache,
    IntegralProblem,
    IntegralSolution,
    IntegralSolver,
    batchsolve,
    init,
    solve,
    solve_,
)
from .parameters import (
    MixedParameters,
    NullParameters,
    ParameterIntegrand,
    paramproduct,
    paramzip,
)
from .wrappers import AuxValue, BatchIntegrand, InplaceIntegrand, NestedBatchIntegrand
from .limits import CubicLimits, TetrahedralLimits, load_limits
from .algorithms.gk import AuxQuadGKJL, QuadGKJL
from .algorithms.hcubature import HCubatureJL
from .algorithms.quadrature import QuadratureFunction
from .algorithms.ptr import AutoSymPTRJL, MonkhorstPack
from .algorithms.nested import NestedQuad
from .algorithms.meta import AbsoluteEstimate, EvalCounter
from .algorithms.pole import ContQuadGKJL, MeroQuadGKJL
from .brillouin import (
    FBZ,
    LatticeRep,
    IAI,
    IBZ,
    PTR,
    TAI,
    AbstractSymRep,
    AutoPTR,
    AutoPTR_IAI,
    CubicSymIBZ,
    InversionSymIBZ,
    PTR_IAI,
    SymmetricBZ,
    TrivialRep,
    UnknownRep,
    canonical_reciprocal_basis,
    load_bz,
    nsyms,
    sym_rep,
    symmetrize,
)
from .fourier import FourierIntegrand, FourierSeries, FourierValue, JacobianSeries
from .dos.interfaces import DOSProblem, DOSSolution
from .dos.ggr import GGR
from .ops.quad_rules import gausslegendre, trapz
from .ops.scomplex import SplitComplex

__version__ = "0.2.0"

__all__ = [
    "AbsoluteEstimate", "AbstractSymRep", "AutoPTR", "AutoPTR_IAI",
    "AutoSymPTRJL", "AuxQuadGKJL", "AuxValue", "Basis", "BatchIntegrand",
    "ContQuadGKJL", "CubicLimits", "CubicSymIBZ", "DOSProblem", "DOSSolution",
    "EvalCounter", "FBZ", "FourierIntegrand", "FourierSeries", "FourierValue",
    "GGR", "HCubatureJL", "HyperCube", "IAI", "IBZ", "InplaceIntegrand",
    "IntegralCache", "IntegralProblem", "IntegralSolution", "IntegralSolver", "LatticeRep",
    "JacobianSeries", "MeroQuadGKJL", "MixedParameters", "MonkhorstPack",
    "NestedBatchIntegrand", "NestedQuad", "NullParameters", "PTR", "PTR_IAI",
    "ParameterIntegrand", "PuncturedInterval", "QuadGKJL", "QuadratureFunction",
    "SplitComplex", "SymmetricBZ", "TAI", "TetrahedralLimits", "TrivialRep", "UnknownRep",
    "batchsolve", "canonical_reciprocal_basis", "gausslegendre", "init",
    "load_bz", "load_limits", "nsyms", "paramproduct", "paramzip", "solve",
    "solve_", "sym_rep", "symmetrize", "trapz",
]
