"""Trust establishment between the host enclave and the accelerator (paper §3.2).

Faithful to the paper's protocol shape, as a host-side control plane:

  1. AUTHENTICATION.  Each accelerator carries endorsement keys (EK_pri burned
     in at manufacture, EK_pub held by the manufacturer CA).  Per session the
     accelerator mints attestation keys (AK) and sends AK_pub + s1 =
     Sign(EK_pri, AK_pub); the host forwards to the CA, which verifies with
     EK_pub and issues a certificate.
  2. KEY EXCHANGE.  Ephemeral Diffie-Hellman signed with AK: the accelerator
     sends (p, g, g^A, s2 = Sign(AK_pri, p||g||g^A)); the host verifies s2,
     replies with g^B; both derive K = KDF(g^AB).

Signatures are Schnorr over the same prime group (discrete-log based, pure
Python ints — this is one-time session setup, not the data plane).  The KDF is
HKDF-SHA256.  Group: RFC 3526 MODP-2048.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import secrets

import numpy as np

# RFC 3526, 2048-bit MODP group (group 14); generator 2.
MODP_2048_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF", 16)
MODP_2048_G = 2
# Schnorr subgroup order q = (p-1)/2 (p is a safe prime).
MODP_2048_Q = (MODP_2048_P - 1) // 2


def _h(*parts: bytes) -> int:
    d = hashlib.sha256()
    for p in parts:
        d.update(len(p).to_bytes(4, "big"))
        d.update(p)
    return int.from_bytes(d.digest(), "big")


def _i2b(x: int) -> bytes:
    return x.to_bytes((x.bit_length() + 7) // 8 or 1, "big")


@dataclasses.dataclass(frozen=True)
class KeyPair:
    sk: int
    pk: int  # g^sk mod p


def keygen(rng=secrets) -> KeyPair:
    sk = rng.randbelow(MODP_2048_Q - 2) + 2
    return KeyPair(sk, pow(MODP_2048_G, sk, MODP_2048_P))


def sign(sk: int, msg: bytes, rng=secrets) -> tuple[int, int]:
    """Schnorr signature (e, s): commit r=g^k, e=H(r||m), s=k+e*sk mod q."""
    k = rng.randbelow(MODP_2048_Q - 2) + 2
    r = pow(MODP_2048_G, k, MODP_2048_P)
    e = _h(_i2b(r), msg) % MODP_2048_Q
    s = (k + e * sk) % MODP_2048_Q
    return e, s


def verify(pk: int, msg: bytes, sig: tuple[int, int]) -> bool:
    e, s = sig
    # r' = g^s * pk^{-e}
    r = (pow(MODP_2048_G, s, MODP_2048_P)
         * pow(pk, MODP_2048_Q - (e % MODP_2048_Q), MODP_2048_P)) % MODP_2048_P
    return _h(_i2b(r), msg) % MODP_2048_Q == e


def hkdf_sha256(ikm: bytes, info: bytes, length: int = 32) -> bytes:
    prk = hmac.new(b"\x00" * 32, ikm, hashlib.sha256).digest()
    out, t = b"", b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


# ---------------------------------------------------------------------------
# Protocol roles
# ---------------------------------------------------------------------------

class ManufacturerCA:
    """Holds EK_pub per device; verifies s1 and issues certificates."""

    def __init__(self):
        self._registry: dict[str, int] = {}
        self._ca_keys = keygen()

    def enroll(self, device_id: str, ek_pub: int) -> None:
        self._registry[device_id] = ek_pub

    def certify(self, device_id: str, ak_pub: int, s1: tuple[int, int]):
        ek_pub = self._registry.get(device_id)
        if ek_pub is None or not verify(ek_pub, _i2b(ak_pub), s1):
            return None
        cert_body = b"AK-CERT|" + device_id.encode() + b"|" + _i2b(ak_pub)
        return (cert_body, sign(self._ca_keys.sk, cert_body))

    @property
    def ca_pub(self) -> int:
        return self._ca_keys.pk


class TrustedAccelerator:
    """Device-side endpoint: EK burned in at 'manufacture', per-session AK + DH."""

    def __init__(self, device_id: str, ca: ManufacturerCA):
        self.device_id = device_id
        self._ek = keygen()
        ca.enroll(device_id, self._ek.pk)
        self._ak: KeyPair | None = None
        self._session_key: bytes | None = None
        self._dh_a: int | None = None

    # step 1: authentication
    def attest(self) -> tuple[int, tuple[int, int]]:
        self._ak = keygen()
        s1 = sign(self._ek.sk, _i2b(self._ak.pk))
        return self._ak.pk, s1

    # step 2: signed ephemeral DH offer
    def dh_offer(self) -> tuple[int, int, int, tuple[int, int]]:
        assert self._ak is not None, "attest() first"
        self._dh_a = secrets.randbelow(MODP_2048_Q - 2) + 2
        ga = pow(MODP_2048_G, self._dh_a, MODP_2048_P)
        msg = _i2b(MODP_2048_P) + _i2b(MODP_2048_G) + _i2b(ga)
        s2 = sign(self._ak.sk, msg)
        return MODP_2048_P, MODP_2048_G, ga, s2

    def dh_finish(self, gb: int) -> None:
        shared = pow(gb, self._dh_a, MODP_2048_P)
        self._session_key = hkdf_sha256(_i2b(shared), b"sealed-offload-v1")

    @property
    def session_key(self) -> bytes:
        assert self._session_key is not None
        return self._session_key


class HostProgram:
    """Enclave-side endpoint (the attested software of the paper)."""

    def __init__(self, ca: ManufacturerCA):
        self._ca = ca
        self._session_key: bytes | None = None

    def establish(self, accel: TrustedAccelerator) -> bytes:
        # 1. authentication
        ak_pub, s1 = accel.attest()
        cert = self._ca.certify(accel.device_id, ak_pub, s1)
        if cert is None:
            raise SecurityError("attestation failed: device not genuine")
        cert_body, cert_sig = cert
        if not verify(self._ca.ca_pub, cert_body, cert_sig):
            raise SecurityError("CA certificate invalid")
        # 2. key exchange
        p, g, ga, s2 = accel.dh_offer()
        if (p, g) != (MODP_2048_P, MODP_2048_G):
            raise SecurityError("unexpected DH group")
        if not verify(ak_pub, _i2b(p) + _i2b(g) + _i2b(ga), s2):
            raise SecurityError("DH offer signature invalid")
        b = secrets.randbelow(MODP_2048_Q - 2) + 2
        gb = pow(g, b, p)
        accel.dh_finish(gb)
        shared = pow(ga, b, p)
        self._session_key = hkdf_sha256(_i2b(shared), b"sealed-offload-v1")
        return self._session_key

    @property
    def session_key(self) -> bytes:
        assert self._session_key is not None
        return self._session_key


class SecurityError(RuntimeError):
    pass


def session_key_to_words(kbytes: bytes) -> "np.ndarray":
    """First 64 bits of the session key as the uint32[2] data-plane cipher key."""
    return np.frombuffer(kbytes[:8], dtype=np.uint32).copy()


def establish_session(device_id: str = "vta-0"):
    """One-call helper: CA + device + host; returns (host, accel, key_words)."""
    ca = ManufacturerCA()
    accel = TrustedAccelerator(device_id, ca)
    host = HostProgram(ca)
    kbytes = host.establish(accel)
    assert kbytes == accel.session_key
    return host, accel, session_key_to_words(kbytes)
