from .coo import COO  # noqa: F401
from .csr import CSR  # noqa: F401
from .ell import EllPlan, build_ell  # noqa: F401
from .plan import MatrixPlan, build_general_plan, build_symmetric_plan  # noqa: F401
from .sdia import SDiaPlan, extract_sdia  # noqa: F401
