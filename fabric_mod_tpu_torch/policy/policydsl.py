"""Policy DSL: "AND('Org1.member', OR('Org2.admin', ...))" -> proto.

(reference: common/policydsl/policyparser.go `FromString` and the
builders in policydsl_builder.go.)  Grammar:

    expr     := AND '(' args ')' | OR '(' args ')'
              | OUTOF '(' n ',' args ')' | principal
    principal:= 'Msp.role' — role in member|admin|client|peer|orderer

AND = OutOf(len), OR = OutOf(1).  Keywords are case-insensitive like
the reference's regexp-based parser; principals must be quoted.
Identical principals are deduplicated into one identities entry, same
as the reference.
"""
from __future__ import annotations

import re
from typing import List, Tuple

from fabric_mod_tpu_torch.protos import messages as m

_ROLES = {
    "member": m.MSPRoleType.MEMBER,
    "admin": m.MSPRoleType.ADMIN,
    "client": m.MSPRoleType.CLIENT,
    "peer": m.MSPRoleType.PEER,
    "orderer": m.MSPRoleType.ORDERER,
}

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<kw>(?i:and|or|outof))\b
    | (?P<num>\d+)
    | (?P<q>'[^']*'|"[^"]*")
    | (?P<punc>[(),])
    )""", re.VERBOSE)


class DslError(Exception):
    pass


def _tokenize(s: str) -> List[Tuple[str, str]]:
    toks, pos = [], 0
    while pos < len(s):
        mt = _TOKEN.match(s, pos)
        if mt is None:
            if s[pos:].strip() == "":
                break
            raise DslError(f"bad token at {s[pos:pos+20]!r}")
        pos = mt.end()
        for kind in ("kw", "num", "q", "punc"):
            v = mt.group(kind)
            if v is not None:
                toks.append((kind, v.lower() if kind == "kw" else v))
                break
    return toks


class _Parser:
    def __init__(self, toks: List[Tuple[str, str]]):
        self.toks = toks
        self.i = 0
        # principal key -> identities index (dedup, like the reference)
        self.principals: dict = {}

    def _peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def _next(self):
        t = self._peek()
        if t[0] is None:
            raise DslError("unexpected end of policy")
        self.i += 1
        return t

    def _expect(self, val: str):
        kind, v = self._next()
        if v != val:
            raise DslError(f"expected {val!r}, got {v!r}")

    def parse(self) -> m.SignaturePolicy:
        rule = self._expr()
        if self._peek()[0] is not None:
            raise DslError(f"trailing input at token {self.i}")
        return rule

    def _expr(self) -> m.SignaturePolicy:
        kind, v = self._next()
        if kind == "kw":
            self._expect("(")
            if v == "outof":
                nk, nv = self._next()
                if nk != "num":
                    raise DslError("OutOf needs a leading count")
                n = int(nv)
                self._expect(",")
            args = [self._expr()]
            while self._peek()[1] == ",":
                self._next()
                args.append(self._expr())
            self._expect(")")
            if v == "and":
                n = len(args)
            elif v == "or":
                n = 1
            elif not 0 <= n <= len(args):
                raise DslError(f"OutOf({n}) with {len(args)} rules")
            return m.SignaturePolicy(n_out_of=m.NOutOf(n=n, rules=args))
        if kind == "q":
            return self._leaf(v[1:-1])
        raise DslError(f"unexpected token {v!r}")

    def _leaf(self, spec: str) -> m.SignaturePolicy:
        if "." not in spec:
            raise DslError(f"principal {spec!r} is not 'Msp.role'")
        mspid, role = spec.rsplit(".", 1)
        if role not in _ROLES:
            raise DslError(f"unknown role {role!r}")
        key = (mspid, role)
        if key not in self.principals:
            self.principals[key] = len(self.principals)
        return m.SignaturePolicy(signed_by=self.principals[key])


def from_string(policy: str) -> m.SignaturePolicyEnvelope:
    """Parse the DSL into a SignaturePolicyEnvelope
    (reference: policyparser.go FromString)."""
    p = _Parser(_tokenize(policy))
    rule = p.parse()
    identities = [
        m.MSPPrincipal(
            principal_classification=m.PrincipalClassification.ROLE,
            principal=m.MSPRole(msp_identifier=mspid,
                                role=_ROLES[role]).encode())
        for (mspid, role) in p.principals
    ]
    return m.SignaturePolicyEnvelope(version=0, rule=rule,
                                     identities=identities)


# -- builders (reference: policydsl_builder.go) -----------------------------

def signed_by_msp_member(mspid: str) -> m.SignaturePolicyEnvelope:
    return from_string(f"OR('{mspid}.member')")


def signed_by_any_member(mspids) -> m.SignaturePolicyEnvelope:
    inner = ", ".join(f"'{x}.member'" for x in mspids)
    return from_string(f"OR({inner})")


def signed_by_majority_admins(mspids) -> m.SignaturePolicyEnvelope:
    n = len(mspids) // 2 + 1
    inner = ", ".join(f"'{x}.admin'" for x in mspids)
    return from_string(f"OutOf({n}, {inner})")
