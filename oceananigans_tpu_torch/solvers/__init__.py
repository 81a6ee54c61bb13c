from .fft_poisson import FFTPoissonSolver, poisson_eigenvalues
from .fourier_tridiagonal import FourierTridiagonalPoissonSolver
from .transforms import apply_matrix_along, dct2_matrix, idct2_matrix

__all__ = ["FFTPoissonSolver", "FourierTridiagonalPoissonSolver",
           "poisson_eigenvalues", "apply_matrix_along", "dct2_matrix",
           "idct2_matrix"]
