"""Membership service providers — the port's copies of
fabric_mod_tpu/msp/ ca.py, identities.py, mspimpl.py and cache.py, over
its own X.509 layer (bccsp/x509.py)."""
