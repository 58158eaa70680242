from .exact_gp import ExactGP, exact_gp_fit_predict
