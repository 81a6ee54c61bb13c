from .fft_poisson import FFTPoissonSolver, poisson_eigenvalues
from .transforms import dct2_matrix, idct2_matrix

__all__ = ["FFTPoissonSolver", "poisson_eigenvalues", "dct2_matrix",
           "idct2_matrix"]
