"""HTTPS admission serving and certificate rotation (webhooks.go:17-63).

- `CertManager` makes a self-signed serving certificate, keeps it in the
  chart's certificate Secret through any kube client with create, get and
  update, and rotates it when it nears expiry (knative's certificates
  reconciler).
- `WebhookServer` serves AdmissionReview v1 over TLS: /default answers
  with a JSONPatch from the in-process defaulters, /validate with allowed
  or denied from the in-process validators (webhooks/__init__.py): one
  admission brain, two transports.

The certificate path needs the `cryptography` package, which a solver's
machine may lack: the module probes for it without importing it, imports
it only where a certificate is made or read, and `require_cryptography`
raises a readable error there, which the process entry turns into a
warning and in-process admission only.
"""
from __future__ import annotations

import base64
import datetime
import importlib.util
import json
import ssl
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from karpenter_core_tpu_torch.api.validation import ValidationError
from karpenter_core_tpu_torch.kube.serialization import from_k8s_dict, to_k8s_dict
from karpenter_core_tpu_torch.webhooks import AdmissionWebhooks

CERT_SECRET_NAME = "karpenter-core-tpu-cert"
ROTATE_BEFORE = datetime.timedelta(days=7)

HAVE_CRYPTOGRAPHY = importlib.util.find_spec("cryptography") is not None


def require_cryptography(what: str) -> None:
    """Raise a self-explanatory error (and leave a structured-log warning)
    when the TLS cert path is exercised without `cryptography` installed.
    Callers that can degrade (the operator's webhook startup) catch it and
    keep serving with in-process admission only."""
    if HAVE_CRYPTOGRAPHY:
        return
    from karpenter_core_tpu_torch.obs.log import get_logger

    get_logger("karpenter.webhooks").warning(
        "webhook TLS unavailable: `cryptography` is not installed",
        feature=what,
    )
    raise RuntimeError(
        f"{what} requires the `cryptography` package, which is not "
        "installed; HTTPS admission serving is disabled (in-process "
        "admission remains active)"
    )


def generate_self_signed_cert(
    common_name: str = "karpenter-webhook",
    dns_names: Tuple[str, ...] = ("localhost",),
    valid_days: int = 90,
) -> Tuple[bytes, bytes]:
    """(cert_pem, key_pem) for the webhook server (knative cert generation
    analog)."""
    require_cryptography("webhook serving-cert generation")
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=valid_days))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName(d) for d in dns_names]),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


def cert_expiry(cert_pem: bytes) -> datetime.datetime:
    require_cryptography("webhook cert-expiry inspection")
    from cryptography import x509

    return x509.load_pem_x509_certificate(cert_pem).not_valid_after_utc


class CertManager:
    """Keeps the chart's cert Secret populated and fresh (the knative
    certificates reconciler, webhooks.go:53-58)."""

    def __init__(self, kube_client, secret_name: str = CERT_SECRET_NAME,
                 namespace: str = "karpenter", dns_names=("localhost",)):
        self.kube_client = kube_client
        self.secret_name = secret_name
        self.namespace = namespace
        self.dns_names = tuple(dns_names)

    def reconcile(self) -> Tuple[bytes, bytes]:
        """Returns (cert_pem, key_pem), generating or rotating through the
        Secret as needed."""
        from karpenter_core_tpu_torch.kube.objects import ObjectMeta, Secret

        secret = self.kube_client.get("Secret", self.namespace, self.secret_name)
        if secret is not None and secret.data.get("tls.crt"):
            cert_pem = base64.b64decode(secret.data["tls.crt"])
            key_pem = base64.b64decode(secret.data["tls.key"])
            now = datetime.datetime.now(datetime.timezone.utc)
            if cert_expiry(cert_pem) - now > ROTATE_BEFORE:
                return cert_pem, key_pem
        cert_pem, key_pem = generate_self_signed_cert(dns_names=self.dns_names)
        data = {
            "tls.crt": base64.b64encode(cert_pem).decode(),
            "tls.key": base64.b64encode(key_pem).decode(),
        }
        if secret is None:
            secret = Secret(
                metadata=ObjectMeta(name=self.secret_name, namespace=self.namespace),
                data=data,
            )
            self.kube_client.create(secret)
        else:
            secret.data = data
            self.kube_client.update(secret)
        return cert_pem, key_pem


class _Handler(BaseHTTPRequestHandler):
    server_version = "karpenter-webhook"

    def log_message(self, *args):  # quiet; prom metrics are the telemetry
        pass

    def do_POST(self):  # noqa: N802 (http.server API)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            review = json.loads(body)
            response = self.server.admission.review(
                review, mutate=self.path.startswith("/default")
            )
        except Exception as exc:  # malformed review -> 400
            self.send_response(400)
            self.end_headers()
            self.wfile.write(str(exc).encode())
            return
        payload = json.dumps(response).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class AdmissionReviewer:
    """AdmissionReview v1 <-> the in-process AdmissionWebhooks brain."""

    def __init__(self):
        from karpenter_core_tpu_torch.api.machine import Machine
        from karpenter_core_tpu_torch.api.provisioner import Provisioner

        self.webhooks = AdmissionWebhooks()
        self.kinds = {"Provisioner": Provisioner, "Machine": Machine}

    def review(self, review: dict, mutate: bool) -> dict:
        request = review.get("request", {})
        uid = request.get("uid", "")
        raw = request.get("object") or {}
        kind = (request.get("kind") or {}).get("kind") or raw.get("kind", "")
        resp = {"uid": uid, "allowed": True}
        cls = self.kinds.get(kind)
        if cls is not None:
            obj = from_k8s_dict(cls, raw)
            # canonical BEFORE-defaulting form: patches are computed
            # canonical-vs-canonical so wire-format canonicalization
            # (camelCase, quantity strings) never looks like a change, and
            # spec keys the model doesn't know are never touched
            before_spec = (to_k8s_dict(obj) or {}).get("spec") or {}
            try:
                admitted = self.webhooks.admit(obj)
            except ValidationError as exc:
                resp["allowed"] = False
                resp["status"] = {"message": str(exc), "code": 400}
            else:
                if mutate:
                    after_spec = (to_k8s_dict(admitted) or {}).get("spec") or {}
                    raw_spec = raw.get("spec") or {}
                    patch = []
                    for key, value in after_spec.items():
                        if before_spec.get(key) != value:
                            patch.append(
                                {"op": "replace" if key in raw_spec else "add",
                                 "path": f"/spec/{key.replace('~', '~0').replace('/', '~1')}",
                                 "value": value}
                            )
                    if patch and "spec" not in raw:
                        patch = [{"op": "add", "path": "/spec", "value": after_spec}]
                    if patch:
                        resp["patchType"] = "JSONPatch"
                        resp["patch"] = base64.b64encode(
                            json.dumps(patch).encode()
                        ).decode()
        return {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": resp,
        }


class WebhookServer:
    """TLS admission endpoint (webhooks.go:17-63). The serving cert's SANs
    cover the in-cluster service DNS name so an apiserver pointed at the
    chart's Service can verify it; a background loop re-runs the
    CertManager and reloads the listener when the cert rotates."""

    def __init__(self, kube_client, host: str = "127.0.0.1", port: int = 0,
                 namespace: str = "karpenter",
                 service_name: str = "karpenter-core-tpu",
                 rotation_check_interval: float = 6 * 3600.0):
        dns_names = (
            "localhost",
            f"{service_name}.{namespace}.svc",
            f"{service_name}.{namespace}.svc.cluster.local",
        )
        if host not in ("0.0.0.0", ""):
            dns_names = (host,) + dns_names
        self.cert_manager = CertManager(kube_client, namespace=namespace,
                                        dns_names=dns_names)
        self.host = host
        self.port = port
        self.rotation_check_interval = rotation_check_interval
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._cert_pem: Optional[bytes] = None
        self._stop = threading.Event()
        self._rotator: Optional[threading.Thread] = None

    def _serve(self, cert_pem: bytes, key_pem: bytes) -> int:
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.admission = AdmissionReviewer()
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        with tempfile.NamedTemporaryFile(suffix=".crt") as cf, \
                tempfile.NamedTemporaryFile(suffix=".key") as kf:
            cf.write(cert_pem)
            cf.flush()
            kf.write(key_pem)
            kf.flush()
            ctx.load_cert_chain(cf.name, kf.name)
        httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
        self._httpd = httpd
        self._cert_pem = cert_pem
        self._thread = threading.Thread(
            target=httpd.serve_forever, daemon=True, name="webhook-https"
        )
        self._thread.start()
        return httpd.server_address[1]

    def start(self) -> int:
        """Serve in a background thread; returns the bound port. Raises a
        clear RuntimeError (after a structured-log warning) when
        `cryptography` is missing — the operator catches it and degrades
        to in-process admission."""
        require_cryptography("webhook HTTPS serving")
        cert_pem, key_pem = self.cert_manager.reconcile()
        port = self._serve(cert_pem, key_pem)
        self.port = port  # keep the bound port across rotation restarts
        self._rotator = threading.Thread(
            target=self._rotate_loop, daemon=True, name="webhook-cert-rotator"
        )
        self._rotator.start()
        return port

    def _rotate_loop(self) -> None:
        """Periodic rotation (the knative certificates reconciler keeps
        running for the process lifetime, not just at startup)."""
        while not self._stop.wait(self.rotation_check_interval):
            try:
                cert_pem, key_pem = self.cert_manager.reconcile()
            except Exception:
                continue  # transient apiserver trouble; retry next tick
            if cert_pem != self._cert_pem and not self._stop.is_set():
                self._shutdown_httpd()
                self._serve(cert_pem, key_pem)

    def _shutdown_httpd(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def stop(self) -> None:
        """Stop serving and rotating, and join both threads."""
        self._stop.set()
        thread = self._thread
        self._shutdown_httpd()
        for t in (self._rotator, thread):
            if t is not None:
                t.join(timeout=5.0)
