"""mTLS certificate generation — a copy of :mod:`tpfl.utils.certificates`
(the reference's ``gen-certs.sh`` as a function: a CA, and server and
client certificates signed by it, for the TCP transport's mutual TLS).

No interactive config files: the loopback SANs (``DNS:localhost``,
``IP:127.0.0.1``) are injected so hostname verification passes in tests
and examples, and everything lands in a caller-chosen directory.
Requires the ``openssl`` CLI.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

from tpfl_torch.settings import Settings


def _run(*cmd: str) -> None:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"openssl failed ({' '.join(cmd[:4])}...): {proc.stdout[-500:]}")


def generate_certificates(
    out_dir: str,
    common_name: str = "127.0.0.1",
    san: str = "DNS:localhost,IP:127.0.0.1",
    days: int = 365,
) -> dict[str, str]:
    """Generate ca/server/client keypairs + CA-signed certs into
    ``out_dir``. Returns a dict of paths keyed like the ``Settings``
    fields (``CA_CRT``, ``SERVER_CRT``, ...)."""
    os.makedirs(out_dir, exist_ok=True)

    def p(name: str) -> str:
        return os.path.join(out_dir, name)

    ext = p("san.cnf")
    with open(ext, "w") as f:
        f.write(f"subjectAltName={san}\n")
    _run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", p("ca.key"), "-out", p("ca.crt"), "-days", str(days),
         "-subj", "/CN=tpfl-ca")
    for role in ("server", "client"):
        _run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
             "-keyout", p(f"{role}.key"), "-out", p(f"{role}.csr"),
             "-subj", f"/CN={common_name}")
        _run("openssl", "x509", "-req", "-in", p(f"{role}.csr"),
             "-CA", p("ca.crt"), "-CAkey", p("ca.key"), "-CAcreateserial",
             "-out", p(f"{role}.crt"), "-days", str(days), "-extfile", ext)
    return {
        "CA_CRT": p("ca.crt"),
        "SERVER_CRT": p("server.crt"),
        "SERVER_KEY": p("server.key"),
        "CLIENT_CRT": p("client.crt"),
        "CLIENT_KEY": p("client.key"),
    }


def enable_mtls(cert_dir: str, paths: Optional[dict[str, str]] = None) -> None:
    """Point ``Settings`` at generated certs and switch the TCP transport
    to mutual TLS (the server requires client certificates)."""
    paths = paths or generate_certificates(cert_dir)
    Settings.CA_CRT = paths["CA_CRT"]
    Settings.SERVER_CRT = paths["SERVER_CRT"]
    Settings.SERVER_KEY = paths["SERVER_KEY"]
    Settings.CLIENT_CRT = paths["CLIENT_CRT"]
    Settings.CLIENT_KEY = paths["CLIENT_KEY"]
    Settings.USE_SSL = True
