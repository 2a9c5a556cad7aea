"""Carry state across from the JAX package and back.

This system has no weights.  What the two packages share are constants
— the Montgomery FieldSpec arrays of p and n and the two G tables —,
the device-layout inputs of the verify core: (K, batch) f32 limb planes
and (N_WINDOWS, batch) int32 window planes, and a channel's membership:
certificates, keys and policies, and an idemix issuer's keys,
credentials, presentations and revocation lists.  These functions take
the reference's numpy arrays, bytes and plain dicts (never its modules
or objects) and return the port's tensors and objects, and back.
"""
from __future__ import annotations

import json
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from fabric_mod_tpu_torch.idemix import credential, revocation
from fabric_mod_tpu_torch.msp import idemixmsp

_FIELDSPEC_ARRAYS = ("p", "one", "one_mont", "r2", "np_mat", "p_mat",
                     "kp32", "lift32")


def limbs_from_reference(arr, device="cpu") -> torch.Tensor:
    """A reference limb plane ((K, batch) f32) or window plane
    ((N_WINDOWS, batch) int) -> a tensor of the same values on `device`
    (float planes stay float32, integer planes become int32)."""
    a = np.asarray(arr)
    dtype = torch.float32 if np.issubdtype(a.dtype, np.floating) \
        else torch.int32
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)


def limbs_to_reference(t: torch.Tensor) -> np.ndarray:
    """A port tensor -> a numpy array the reference accepts (float32 or
    int32, same layout)."""
    a = t.detach().cpu().numpy()
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    return a.astype(np.int32)


def fieldspec_arrays(spec) -> Dict[str, np.ndarray]:
    """The numpy arrays of a FieldSpec (either package's), by name."""
    return {name: np.asarray(getattr(spec, name)) for name in _FIELDSPEC_ARRAYS}


def constants_from_reference(fieldspec_arrays: Mapping[str, Mapping[str, np.ndarray]],
                             g_table: np.ndarray, g_table_affine: np.ndarray,
                             device="cpu") -> Dict[str, object]:
    """The reference's constants as the port's tensors.

    fieldspec_arrays: {field name: {array name: array}} (e.g. from
    `fieldspec_arrays(spec)` per field); g_table: (3, TABLE, K);
    g_table_affine: (2, TABLE-1, K).  Returns {"fields": {field:
    {array name: tensor}}, "g_table": tensor, "g_table_affine":
    tensor}."""
    fields = {}
    for fname, arrays in fieldspec_arrays.items():
        fields[fname] = {name: torch.as_tensor(np.ascontiguousarray(arrays[name]),
                                               device=device)
                         for name in _FIELDSPEC_ARRAYS}
    return {
        "fields": fields,
        "g_table": limbs_from_reference(g_table, device),
        "g_table_affine": limbs_from_reference(g_table_affine, device),
    }


def world_from_reference(ca_cert_pems: Mapping[str, bytes],
                         signer_pems: Mapping[str, Tuple[str, bytes, bytes]],
                         policy: bytes, raw_messages: bool = False,
                         channel_id: str = "bench"):
    """A block-commit world of the reference, carried across as plain
    bytes: {org: CA certificate PEM}, {signer name: (mspid,
    certificate PEM, PKCS#8 private-key PEM)} and the endorsement
    policy's ApplicationPolicy bytes.  Returns the port's
    utils/fixtures.CommitWorld over the same certificates and keys.
    Only bytes are accepted, so no object of the reference crosses."""
    for pem in (*ca_cert_pems.values(), policy,
                *(b for s in signer_pems.values() for b in s[1:])):
        if not isinstance(pem, bytes):
            raise TypeError(f"expected bytes, got {type(pem).__name__}")
    from fabric_mod_tpu_torch.utils import fixtures
    return fixtures.world_from_pems(
        dict(ca_cert_pems),
        {name: (str(mspid), cert, key)
         for name, (mspid, cert, key) in signer_pems.items()},
        policy, raw_messages=raw_messages, channel_id=channel_id)



# --- idemix: issuer keys, credentials, presentations and CRIs as data ----

def _plain_dict(d) -> dict:
    if not isinstance(d, dict):
        raise TypeError(f"expected a dict, got {type(d).__name__}")
    return d


def issuer_key_from_reference(d: dict) -> credential.IssuerKey:
    """A reference `IssuerKey.to_dict()` (or `public_dict()`) -> the
    port's IssuerKey (its proof of knowledge is checked)."""
    return credential.IssuerKey.from_dict(_plain_dict(d))


def credential_from_reference(d: dict) -> credential.Credential:
    """A reference `Credential.to_dict()` -> the port's Credential."""
    return credential.Credential.from_dict(_plain_dict(d))


def presentation_from_reference(sig_bytes: bytes) -> credential.Signature:
    """A presentation as the idemix MSP's JSON signature bytes -> the
    port's Signature."""
    if not isinstance(sig_bytes, bytes):
        raise TypeError(f"expected bytes, got {type(sig_bytes).__name__}")
    return idemixmsp._sig_from_dict(json.loads(sig_bytes))


def presentation_to_reference(sig: credential.Signature) -> bytes:
    """The port's Signature -> the idemix MSP's JSON signature bytes,
    which the reference reads with its `_sig_from_dict(json.loads(...))`."""
    return json.dumps(idemixmsp._sig_to_dict(sig), sort_keys=True).encode()


def cri_from_reference(d: dict) -> revocation.CRI:
    """A reference `CRI.to_dict()` -> the port's CRI."""
    return revocation.CRI.from_dict(_plain_dict(d))
