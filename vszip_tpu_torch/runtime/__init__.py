"""Host-side native helpers (C++ under ``native/``, built with g++ at first
use): Deband's create-time RNG precompute and the error-diffusion demote."""
