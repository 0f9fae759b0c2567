"""The linear gVAMP engine and its metrics."""
