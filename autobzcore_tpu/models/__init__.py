from .berry import (BerryCurvatureSolver, BerryPack, berry_pack,
                    certified_berry, lattice_chern, wilson_loop_spectrum,
                    z2_invariant)
from .lindhard import LindhardSolver, certified_chi0, cooper_bubble
from .kpath import (KPath, band_structure, expectation_path, kpath,
                    spectral_path)
from .selfenergy import (SigmaCallable, SigmaDOSSolver, SigmaInterpolant,
                         SigmaKineticCoefficientSolver,
                         SigmaTransportSolver, certified_sigma_dos,
                         dos_integrand_sigma, dos_trace_sigma,
                         greens_trace_sigma, transport_distribution_sigma)
from .observables import (CertifiedSweep, SpectralPack, TransportSolver,
                          certified_ladder,
                          certified_transport_sweep, spectral_velocity_pack)
from .tight_binding import (cubic_t2g, flagship_model, integer_lattice, synthetic_wannier, t2g_rep,
                            tb_graphene,
                            tb_haldane, tb_integer, tb_kane_mele,
                            tb_kane_mele_sz, tb_weyl)
from .transport import (ElectronCountSolver, KineticCoefficientSolver, fermi,
                        fermi_window, fermi_window_limits, optical_conductivity)

__all__ = [
    "cubic_t2g", "flagship_model", "integer_lattice", "synthetic_wannier", "t2g_rep", "tb_graphene", "tb_haldane",
    "tb_integer", "tb_kane_mele", "tb_kane_mele_sz", "tb_weyl", "BerryCurvatureSolver", "BerryPack", "berry_pack", "lattice_chern", "wilson_loop_spectrum", "z2_invariant",
    "ElectronCountSolver", "KineticCoefficientSolver", "fermi", "fermi_window",
    "fermi_window_limits", "optical_conductivity",
    "CertifiedSweep", "SpectralPack", "TransportSolver",
    "certified_ladder", "certified_transport_sweep", "spectral_velocity_pack",
    "KPath", "band_structure", "expectation_path", "kpath", "spectral_path",
    "LindhardSolver", "certified_berry", "certified_chi0", "cooper_bubble",
    "SigmaCallable", "SigmaDOSSolver", "SigmaInterpolant",
    "SigmaKineticCoefficientSolver", "SigmaTransportSolver", "certified_sigma_dos", "dos_integrand_sigma",
    "dos_trace_sigma", "greens_trace_sigma", "transport_distribution_sigma",
]
