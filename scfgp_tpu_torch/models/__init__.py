from .params import (SCFGPParams, DerivedFrequencies, init_params,
                     pack_params, unpack_params, num_params,
                     derive_frequencies, params_from_numpy,
                     posterior_from_numpy, opt_state_from_numpy,
                     opt_state_to_numpy)
from .objective import (SufficientStats, Posterior, LossAux, fourier_features,
                        feature_block, sufficient_stats, chol_and_inverse,
                        solve_posterior, latent_moments, expected_nll_rows,
                        kl_penalty, loss_fn, loss_and_grad, loss_from_phi,
                        predict_f, predict_from_phi)
