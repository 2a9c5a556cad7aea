"""The ledger half of the block commit — the port's copies of
fabric_mod_tpu/ledger/ rwsetutil.py, statedb.py and the generic MVCC
pass, and a lean in-memory KvLedger whose state fingerprint equals the
reference ledger's."""
