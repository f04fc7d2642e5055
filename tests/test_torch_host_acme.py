"""The port's ACME client (`pingoo_tpu_torch.host.acme`) on every case of
test_acme.py, against the same local mock RFC 8555 directory
(test_acme.MockCa: http-01 validation through the client's challenge
store, no network egress). The port's JWK thumbprints equal the JAX
package's for the same key."""

import json

from cryptography import x509

from pingoo_tpu.host import jwt as ref_jose
from pingoo_tpu_torch.host import jwt as jose
from pingoo_tpu_torch.host.acme import AcmeManager
from test_acme import MockCa


class TestAcme:
    def test_full_order_flow(self, loop_runner, tmp_path):
        async def flow():
            ca = MockCa()
            await ca.start()
            try:
                manager = AcmeManager(
                    str(tmp_path), ["example.test"],
                    directory_url=ca.url("/dir"))

                async def fetch(token):
                    return manager.challenges.get(token)

                ca.challenge_fetcher = fetch
                await manager.renew_all()
                return ca, manager
            finally:
                await ca.stop()
                await manager.client.close()

        ca, manager = loop_runner.run(flow())
        cert_path = tmp_path / "example.test.pem"
        key_path = tmp_path / "example.test.key"
        assert cert_path.exists() and key_path.exists()
        cert = x509.load_pem_x509_certificate(cert_path.read_bytes())
        sans = cert.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        assert sans.get_values_for_type(x509.DNSName) == ["example.test"]
        # Key authorization was published and validated, then cleaned up.
        assert len(ca.validated_keyauths) == 1
        assert manager.challenges == {}
        # Account persisted (versioned doc, acme.rs AcmeConfig::V1).
        doc = json.loads((tmp_path / "acme.json").read_text())
        assert doc["version"] == 1 and doc["account_url"]
        # The key authorization the CA validated ends in the account
        # key's RFC 7638 thumbprint, as the CA computes it.
        assert ca.validated_keyauths[0].endswith(
            "." + ca.account_thumbprint)

    def test_renewal_detection(self, loop_runner, tmp_path):
        from pingoo_tpu_torch.host.tlsmgr import generate_self_signed

        # Fresh cert -> no renewal needed.
        cert, key = generate_self_signed(["good.test"], valid_days=90)
        (tmp_path / "good.test.pem").write_bytes(cert)
        (tmp_path / "good.test.key").write_bytes(key)
        # Expiring cert -> renewal needed.
        cert, key = generate_self_signed(["old.test"], valid_days=5)
        (tmp_path / "old.test.pem").write_bytes(cert)
        manager = AcmeManager(str(tmp_path),
                              ["good.test", "old.test", "missing.test"],
                              directory_url="http://unused/dir")
        needed = manager.domains_needing_certificates()
        assert needed == ["old.test", "missing.test"]

    def test_thumbprint_shape(self):
        key = jose.Key.generate(jose.ALG_ES256)
        tp = jose.jwk_thumbprint(key)
        assert len(tp) == 43  # 32 bytes b64url, no padding
        ref_key = ref_jose.Jwks.from_json(jose.Jwks(keys=[key]).to_json(
            include_private=True)).keys[0]
        assert ref_jose.jwk_thumbprint(ref_key) == tp
