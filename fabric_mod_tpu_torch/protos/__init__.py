"""Wire messages — the port's copies of fabric_mod_tpu/protos/wire.py,
messages.py and protoutil.py (verbatim but for the imports), so blocks
and envelopes encode to the same bytes in both packages."""
