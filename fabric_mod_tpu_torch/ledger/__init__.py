"""The ledger half of the block commit — the port's copies of
fabric_mod_tpu/ledger/ rwsetutil.py, statedb.py, mvcc.py, durable.py,
confighistory.py, pvtdata.py, richquery.py, snapshot.py and admin.py,
and the KvLedger (durable by default) whose files, snapshots and state
fingerprint are the reference ledger's."""
