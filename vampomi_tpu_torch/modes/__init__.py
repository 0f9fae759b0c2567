"""The run modes beside inference: out-of-sample `test`, `association_test`
(SE and LOO p-values) and `predict`."""
