from .conjugate_gradient import (ConjugateGradientPoissonSolver,
                                 conjugate_gradient,
                                 make_immersed_poisson_solver)
from .fft_poisson import FFTPoissonSolver, poisson_eigenvalues
from .fourier_tridiagonal import (FourierTridiagonalPoissonSolver,
                                  make_variable_spacing_poisson_solver)
from .krylov import KrylovSolver
from .transforms import apply_matrix_along, dct2_matrix, idct2_matrix

__all__ = ["ConjugateGradientPoissonSolver", "FFTPoissonSolver",
           "FourierTridiagonalPoissonSolver", "KrylovSolver",
           "conjugate_gradient", "make_immersed_poisson_solver",
           "make_variable_spacing_poisson_solver", "poisson_eigenvalues",
           "apply_matrix_along", "dct2_matrix", "idct2_matrix"]
