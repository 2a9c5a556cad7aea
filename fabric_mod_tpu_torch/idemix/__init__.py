"""Idemix anonymous credentials over FP256BN pairings — the port's
copies of fabric_mod_tpu/idemix/ (host fp256bn reference, credentials,
revocation); the batched pairing lives in ops/fp256bn_dev.py."""
