"""The probit GLM: z-denoisers and the covariate Newton solver."""
