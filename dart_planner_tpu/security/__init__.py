"""Security service layer (thin, optional — SURVEY.md section 2.8).

Functional rebuild of the reference ``src/dart_planner/security/``:
JWT-style RS256 tokens with roles/permissions (auth.py), a token-bucket /
lockout rate limiter (rate_limiter.py), input validation helpers
(validation.py), and file-integrity verification (file_verification.py).
Implemented on the stdlib + ``cryptography`` (PyJWT is not in this
image); peripheral to the accelerator compute path by design.
"""

from dart_planner_tpu.security.auth import (
    AuthManager,
    Role,
    TokenError,
    User,
    generate_rsa_keypair,
)
from dart_planner_tpu.security.rate_limiter import RateLimitConfig, RateLimiter
from dart_planner_tpu.security.validation import (
    SafetyLimits,
    validate_attitude,
    validate_command_envelope,
    validate_control_command,
    validate_identifier,
    validate_position,
    validate_sensor_data,
    validate_trajectory,
    validate_waypoints,
)
from dart_planner_tpu.security.file_verification import (
    FileRecord,
    FileVerificationManager,
    compute_file_digest,
    create_file_verification,
    verify_file_digest,
    verify_file_integrity,
)

__all__ = [
    "AuthManager",
    "Role",
    "TokenError",
    "User",
    "generate_rsa_keypair",
    "RateLimitConfig",
    "RateLimiter",
    "SafetyLimits",
    "validate_attitude",
    "validate_command_envelope",
    "validate_control_command",
    "validate_identifier",
    "validate_position",
    "validate_sensor_data",
    "validate_trajectory",
    "validate_waypoints",
    "FileRecord",
    "FileVerificationManager",
    "compute_file_digest",
    "create_file_verification",
    "verify_file_digest",
    "verify_file_integrity",
]

from dart_planner_tpu.security.key_derivation import (  # noqa: E402
    KeyDerivationError,
    OSKeyStoreError,
    derive_key_from_passphrase,
    derive_key_from_scrypt,
    generate_secure_key,
    validate_key_strength,
)
from dart_planner_tpu.security.key_manager import (  # noqa: E402
    KeyConfig,
    SecureKeyManager,
    get_key_manager,
    set_key_manager,
)
from dart_planner_tpu.security.credentials import (  # noqa: E402
    Credential,
    SecureCredentialManager,
)

__all__ += [
    "KeyDerivationError",
    "OSKeyStoreError",
    "derive_key_from_passphrase",
    "derive_key_from_scrypt",
    "generate_secure_key",
    "validate_key_strength",
    "KeyConfig",
    "SecureKeyManager",
    "get_key_manager",
    "set_key_manager",
    "Credential",
    "SecureCredentialManager",
]

from dart_planner_tpu.security.db import UserService  # noqa: E402

__all__ += ["UserService"]

from dart_planner_tpu.security.permissions import (  # noqa: E402
    PERMISSION_GROUPS,
    ROLE_MATRIX,
    Permission,
    get_permissions_by_group,
    get_role_permissions,
    get_roles_with_permission,
    has_all_permissions,
    has_any_permission,
    has_legacy_permission,
    has_permission,
)

from dart_planner_tpu.security import credential_helpers  # noqa: E402,F401
from dart_planner_tpu.security import secure_files  # noqa: E402,F401

__all__ += [
    "credential_helpers",
    "secure_files",
    "PERMISSION_GROUPS",
    "ROLE_MATRIX",
    "Permission",
    "get_permissions_by_group",
    "get_role_permissions",
    "get_roles_with_permission",
    "has_all_permissions",
    "has_any_permission",
    "has_legacy_permission",
    "has_permission",
]
