from .phi import (FourierFeatures, fourier_features_bwd_cuda,
                  fourier_features_cuda, fourier_features_ref, phi_bwd_ref)
