"""Access control SPI.

Port of presto_tpu/security.py (pure Python). Reference: presto-spi
spi/security/* — SystemAccessControl +
ConnectorAccessControl checks (checkCanExecuteQuery, checkCanSelect...,
denials raise AccessDeniedException). The engine consults ONE installed
AccessControl (plugins contribute it; default allows everything) at two
choke points: statement admission and planned table access — the same
places the reference's AccessControlManager sits in the analyzer.
"""

from __future__ import annotations

from typing import Sequence


class AccessDeniedError(PermissionError):
    """Reference: spi/security/AccessDeniedException."""

    def __init__(self, what: str):
        super().__init__(f"Access Denied: {what}")


class AccessControl:
    """Override any subset; the default allows everything (reference:
    AllowAllAccessControl). Deny by raising AccessDeniedError (the
    `deny` helper formats the message like the reference does)."""

    @staticmethod
    def deny(what: str):
        raise AccessDeniedError(what)

    def check_can_execute_query(self, user: str, sql: str) -> None:
        pass

    def check_can_select(self, user: str, catalog: str, table: str,
                         columns: Sequence[str]) -> None:
        pass

    def check_can_create_table(self, user: str, catalog: str,
                               table: str) -> None:
        pass

    def check_can_insert(self, user: str, catalog: str,
                         table: str) -> None:
        pass

    def check_can_delete(self, user: str, catalog: str,
                         table: str) -> None:
        pass

    def check_can_update(self, user: str, catalog: str,
                         table: str) -> None:
        pass

    def check_can_drop_table(self, user: str, catalog: str,
                             table: str) -> None:
        pass

    def check_can_create_view(self, user: str, catalog: str,
                              name: str) -> None:
        pass

    def check_can_drop_view(self, user: str, catalog: str,
                            name: str) -> None:
        pass

    def check_can_set_session(self, user: str, name: str) -> None:
        pass


ALLOW_ALL = AccessControl()
