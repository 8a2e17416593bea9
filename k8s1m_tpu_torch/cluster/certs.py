"""Self-signed TLS provisioning for the rig — the terraform role.

The reference provisions webhook TLS out-of-band: a terraform
``tls_self_signed_cert`` CA signs a server cert whose SANs cover the
webhook Service, and the cert/key land in ``/etc/webhook/certs`` for the
server (reference terraform/kubernetes/dist-scheduler.tf:713-740,
pkg/webhook/webhook.go:33-35); the VM metrics proxies get the same
treatment (terraform/k8s-server/server.tf:204-229).

Here the same chain is one function: ``provision(dir)`` writes a CA and
a CA-signed server cert/key and returns ready-to-use ``ssl.SSLContext``
builders for both sides.  The port's copy of ``k8s1m_tpu/cluster/certs.py``:
the watch-cache tier (``store/watch_cache.py``) serves its secured wire
with this chain, and tests use the client context to verify it end to end
(a client without the CA must fail).  Where ``cryptography`` is not
installed the chain comes from the ``openssl`` command.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
import ssl


@dataclasses.dataclass
class CertPaths:
    ca_pem: str
    cert_pem: str
    key_pem: str

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_pem, self.key_pem)
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """Verifying client context: trusts only this rig's CA."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(self.ca_pem)
        return ctx


def provision(
    cert_dir: str,
    *,
    common_name: str = "k8s1m-webhook",
    hostnames: tuple[str, ...] = ("localhost",),
    ips: tuple[str, ...] = ("127.0.0.1",),
    days: int = 7,
) -> CertPaths:
    """Write ca.pem / cert.pem / key.pem under ``cert_dir``.

    CA-signed (not bare self-signed) so clients exercise real chain
    verification, like the reference's terraform chain.  Uses the
    ``cryptography`` package when importable, else shells out to the
    ``openssl`` CLI (same chain shape) so minimal containers can still
    run the secured-tier drills.
    """
    try:
        from cryptography import x509
    except ImportError:
        return _provision_openssl(
            cert_dir, common_name=common_name, hostnames=hostnames,
            ips=ips, days=days,
        )
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    os.makedirs(cert_dir, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=days)

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "k8s1m-rig-ca")]
    )
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), True)
        .sign(ca_key, hashes.SHA256())
    )

    key = ec.generate_private_key(ec.SECP256R1())
    san = x509.SubjectAlternativeName(
        [x509.DNSName(h) for h in hostnames]
        + [x509.IPAddress(ipaddress.ip_address(i)) for i in ips]
    )
    cert = (
        x509.CertificateBuilder()
        .subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
        )
        .issuer_name(ca_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(not_after)
        .add_extension(san, False)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), True)
        .sign(ca_key, hashes.SHA256())
    )

    paths = CertPaths(
        ca_pem=os.path.join(cert_dir, "ca.pem"),
        cert_pem=os.path.join(cert_dir, "cert.pem"),
        key_pem=os.path.join(cert_dir, "key.pem"),
    )
    with open(paths.ca_pem, "wb") as f:
        f.write(ca_cert.public_bytes(serialization.Encoding.PEM))
    with open(paths.cert_pem, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(paths.key_pem, "wb") as f:
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption(),
            )
        )
    return paths


def _provision_openssl(
    cert_dir: str,
    *,
    common_name: str,
    hostnames: tuple[str, ...],
    ips: tuple[str, ...],
    days: int,
) -> CertPaths:
    """The same CA -> server-cert chain via the openssl CLI (P-256 keys,
    SHA-256, SANs, PKCS8 server key — byte-compatible consumers)."""
    import subprocess

    os.makedirs(cert_dir, exist_ok=True)
    paths = CertPaths(
        ca_pem=os.path.join(cert_dir, "ca.pem"),
        cert_pem=os.path.join(cert_dir, "cert.pem"),
        key_pem=os.path.join(cert_dir, "key.pem"),
    )
    ca_key = os.path.join(cert_dir, "ca_key.pem")
    raw_key = os.path.join(cert_dir, "key_ec.pem")
    csr = os.path.join(cert_dir, "csr.pem")
    ext = os.path.join(cert_dir, "ext.cnf")
    ca_cnf = os.path.join(cert_dir, "ca.cnf")
    san = ",".join(
        [f"DNS:{h}" for h in hostnames] + [f"IP:{i}" for i in ips]
    )
    with open(ext, "w") as f:
        f.write(
            f"subjectAltName={san}\n"
            "basicConstraints=critical,CA:FALSE\n"
            "subjectKeyIdentifier=hash\n"
            "authorityKeyIdentifier=keyid\n"
        )
    # Explicit config: the system default req config ALSO appends
    # basicConstraints, and a duplicated extension fails verification.
    with open(ca_cnf, "w") as f:
        f.write(
            "[req]\ndistinguished_name=dn\nx509_extensions=v3_ca\n"
            "prompt=no\n[dn]\nCN=k8s1m-rig-ca\n[v3_ca]\n"
            "basicConstraints=critical,CA:TRUE,pathlen:0\n"
            "subjectKeyIdentifier=hash\n"
        )

    def run(*cmd: str) -> None:
        subprocess.run(
            cmd, check=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    try:
        run("openssl", "ecparam", "-name", "prime256v1", "-genkey",
            "-noout", "-out", ca_key)
        run("openssl", "req", "-x509", "-new", "-key", ca_key,
            "-config", ca_cnf, "-days", str(days), "-sha256",
            "-out", paths.ca_pem)
        run("openssl", "ecparam", "-name", "prime256v1", "-genkey",
            "-noout", "-out", raw_key)
        run("openssl", "pkcs8", "-topk8", "-nocrypt", "-in", raw_key,
            "-out", paths.key_pem)
        run("openssl", "req", "-new", "-key", paths.key_pem,
            "-subj", f"/CN={common_name}", "-out", csr)
        run("openssl", "x509", "-req", "-in", csr, "-CA", paths.ca_pem,
            "-CAkey", ca_key, "-CAcreateserial", "-days", str(days),
            "-sha256", "-extfile", ext, "-out", paths.cert_pem)
    finally:
        # Scrub even when an openssl step fails: ca_key in particular —
        # the cryptography path keeps the CA key in memory only, and a
        # CA key left readable in cert_dir would let anything that can
        # read it mint trusted certs (the .srl serial file rides along).
        srl = os.path.splitext(paths.ca_pem)[0] + ".srl"
        for scratch in (raw_key, csr, ext, ca_cnf, ca_key, srl):
            if os.path.exists(scratch):
                os.unlink(scratch)
    return paths
