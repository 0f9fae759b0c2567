"""The linear and probit gVAMP engines and their metrics."""
