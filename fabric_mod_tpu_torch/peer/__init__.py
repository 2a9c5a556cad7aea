"""Block validation and commit — the port's copies of
fabric_mod_tpu/peer/txvalidator.py and plugins.py."""
