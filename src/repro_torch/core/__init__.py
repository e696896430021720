from .amp import amp_solve, sample_problem
from .denoisers import BernoulliGauss, eta, mmse, make_mmse_interp
from .state_evolution import CSProblem, PAPER_T, sdr, se_trajectory
from .mp_amp import MPAMPConfig, MPAMPResult, mp_amp_solve
from .rate_alloc import BTController, bt_schedule_offline, dp_allocate
from .rate_distortion import RDModel
