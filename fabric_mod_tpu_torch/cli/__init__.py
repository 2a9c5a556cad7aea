"""The port's offline tools (reference: fabric_mod_tpu/cli/; cmd/ and
internal/{cryptogen,configtxgen} of the reference system).  `node` and
`chaincode` come with the transport."""
