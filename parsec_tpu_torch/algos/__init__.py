from .gemm import build_gemm, k_gemm_nn
from .inverse import (build_lauum, build_trtri, lauum_flops, run_potri,
                      trtri_flops)
from .lu import (build_getrf_nopiv, build_getrf_panels, getrf_flops,
                 getrf_nopiv_reference)
from .potrf import (build_potrf, build_potrf_panels, build_potrs_panels,
                    potrf_flops, run_potrf)
from .qr import build_geqrf, geqrf_flops
from .trsm import build_trsm

__all__ = ["build_gemm", "k_gemm_nn",
           "build_getrf_nopiv", "build_getrf_panels", "getrf_flops",
           "getrf_nopiv_reference",
           "build_potrf", "build_potrf_panels", "build_potrs_panels",
           "run_potrf", "potrf_flops",
           "build_geqrf", "geqrf_flops", "build_trsm",
           "build_trtri", "build_lauum", "run_potri", "trtri_flops",
           "lauum_flops"]
