"""Typed environment-variable parsing on validator descriptors.

Counterpart of cosmos_predict2_tpu/utils/env_parsers.py (the reference's
imaginaire/utils/env_parsers/env_parser.py:38-120 base,
cred_env_parser.py:20-43 credentials, inference_env_parser.py:20-36
serving knobs): an :class:`EnvParser` subclass declares
:mod:`~cosmos_predict2_tpu_torch.utils.validator` descriptors as UPPER_CASE
class attributes, and construction reads the same-named environment
variables through them: typed coercion ("8" -> 8, "true" -> True), range
checks and mandatory fields in one place. The whole parameter set
round-trips through base64-encoded JSON, so a launcher can hand a worker
its full environment as one opaque string.

The fields are the JAX package's. ``MODEL_MODULE`` names the port's API,
and ``NUM_CHIPS`` counts the visible CUDA devices (0: all of them).
"""

from __future__ import annotations

import base64
import json
import os
from typing import Any

from cosmos_predict2_tpu_torch.utils.validator import Bool, Int, String, Validator

from cosmos_predict2_tpu_torch.utils import log


class EnvParser:
    """Reads each declared validator's UPPER_CASE name from the environment.

    ``EnvParser(b64_str)`` restores a parameter set serialized with
    :meth:`to_b64` instead of reading the environment (env_parser.py:39-45).
    """

    def __init__(self, b64_str: str | None = None):
        if b64_str:
            self.from_b64(b64_str)
        else:
            self.from_env()

    @classmethod
    def get_val_dict(cls) -> dict[str, Validator]:
        out: dict[str, Validator] = {}
        for klass in reversed(cls.__mro__):
            out.update({k: v for k, v in vars(klass).items() if isinstance(v, Validator)})
        return out

    def from_env(self) -> None:
        for key in self.get_val_dict():
            val = os.getenv(key.upper())
            if val is not None and val != "":
                setattr(self, key, val)
        self.check_mandatory_values()

    def from_b64(self, b64_str: str) -> None:
        payload = json.loads(base64.b64decode(b64_str).decode())
        known = self.get_val_dict()
        for key, value in payload.items():
            if key in known:
                setattr(self, key, value)
            else:
                log.warning(f"ignoring unknown env param {key!r} in b64 payload")
        self.check_mandatory_values()

    def check_mandatory_values(self) -> None:
        # a mandatory validator (no default) raises on __get__ when unset;
        # surface that at construction, not first use (env_parser.py:79-82)
        for key in self.get_val_dict():
            getattr(self, key)

    def to_dict(self) -> dict[str, Any]:
        return {key: getattr(self, key) for key in self.get_val_dict()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def to_b64(self) -> str:
        return base64.b64encode(self.to_json().encode()).decode()


class CredentialEnvParser(EnvParser):
    """Object-store credentials (cred_env_parser.py:20-43): one block per
    role; :meth:`backend_args` formats a role into a backend's arguments
    (SigV4 keys, endpoint, region), the keywords utils/remote_io.py's
    ``S3Backend`` takes: ``easy_io.register_backend("s3",
    S3Backend(**CredentialEnvParser().backend_args("TEAM_DIR")))``."""

    APP_ENV = String(default="")

    # s3-style checkpoint store
    CHECKPOINT_ACCESS_KEY_ID = String(default="")
    CHECKPOINT_SECRET_ACCESS_KEY = String(default="")
    CHECKPOINT_ENDPOINT_URL = String(default="https://s3.us-west-2.amazonaws.com")
    CHECKPOINT_REGION_NAME = String(default="us-west-2")

    # s3-style team/data store
    TEAM_DIR_ACCESS_KEY_ID = String(default="")
    TEAM_DIR_SECRET_ACCESS_KEY = String(default="")
    TEAM_DIR_ENDPOINT_URL = String(default="")
    TEAM_DIR_REGION_NAME = String(default="")

    # GCS service account
    GOOGLE_APPLICATION_CREDENTIALS = String(default="")

    def backend_args(self, role: str) -> dict[str, str]:
        role = role.upper()
        if role not in ("CHECKPOINT", "TEAM_DIR"):
            raise ValueError(f"unknown credential role {role!r}")
        return {
            "access_key_id": getattr(self, f"{role}_ACCESS_KEY_ID"),
            "secret_access_key": getattr(self, f"{role}_SECRET_ACCESS_KEY"),
            "endpoint_url": getattr(self, f"{role}_ENDPOINT_URL"),
            "region_name": getattr(self, f"{role}_REGION_NAME"),
        }


class InferenceEnvParser(EnvParser):
    """Serving-deployment knobs (inference_env_parser.py:20-36). The
    parallelism fields are the JAX package's mesh axis sizes; the port
    serves on one card, so they validate and are not used yet."""

    MODEL_MODULE = String(default="cosmos_predict2_tpu_torch.inference.api")
    MODEL_CLASS = String(default="Inference")
    CHECKPOINT_HOME = String(default="checkpoints")
    PORT = Int(default=8000, min=1, max=65535)
    NUM_CHIPS = Int(default=0, min=0)  # visible CUDA devices; 0 = all of them
    CP_SIZE = Int(default=1, min=1)
    TP_SIZE = Int(default=1, min=1)
    FSDP_SHARD_SIZE = Int(default=1, min=1)
    PP_SIZE = Int(default=1, min=1)
    OFFLOAD_GUARDRAILS = Bool(default=False)
    DISABLE_GUARDRAILS = Bool(default=False)


def get_inference_envs() -> InferenceEnvParser:
    return InferenceEnvParser()


def get_credential_envs() -> CredentialEnvParser:
    return CredentialEnvParser()
