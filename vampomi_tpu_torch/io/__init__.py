"""Binary, phenotype and positional-CSV IO (numpy; copied from vampomi_tpu.io)."""
