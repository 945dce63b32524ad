from .gemm import build_gemm, build_gemm_dist, k_gemm_nn, run_gemm
from .inverse import (build_lauum, build_trtri, lauum_flops, run_potri,
                      trtri_flops)
from .lu import (build_getrf_nopiv, build_getrf_panels, getrf_flops,
                 getrf_nopiv_reference)
from .moe import build_moe, make_moe_collections, moe_oracle
from .matrix_ops import (build_apply, build_map_operator, build_reduce_col,
                         build_reduce_row)
from .potrf import (build_potrf, build_potrf_panels, build_potrs_panels,
                    potrf_flops, run_potrf)
from .qr import build_geqrf, geqrf_flops
from .redistribute import redistribute
from .reshape import build_reshape_dtype, reshape_geometry
from .ring_attention import (build_ring_attention, dense_reference,
                             make_collections, run_ring_attention)
from .trsm import build_trsm

__all__ = ["build_gemm", "build_gemm_dist", "run_gemm", "k_gemm_nn",
           "build_getrf_nopiv", "build_getrf_panels", "getrf_flops",
           "getrf_nopiv_reference",
           "build_potrf", "build_potrf_panels", "build_potrs_panels",
           "run_potrf", "potrf_flops",
           "build_apply", "build_map_operator", "build_reduce_col",
           "build_reduce_row", "redistribute",
           "build_reshape_dtype", "reshape_geometry",
           "build_geqrf", "geqrf_flops", "build_trsm",
           "build_trtri", "build_lauum", "run_potri", "trtri_flops",
           "lauum_flops",
           "build_moe", "make_moe_collections", "moe_oracle",
           "build_ring_attention", "make_collections", "run_ring_attention",
           "dense_reference"]
