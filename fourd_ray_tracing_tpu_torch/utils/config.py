"""Config system: `key = value  # comment` properties files, typed.

Counterpart of fourd_ray_tracing_tpu/utils/config.py (same keys, same
parsing rules, same AppConfig fields and defaults), in pure Python: the
port carries its own copy so that it runs without the JAX package. Dotted
keys, '#' comments, a hard error on missing or unparseable keys, optional
keys via `get_string_or_null`; `AppConfig` groups them so a render is
reproducible from (config, seed).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from fourd_ray_tracing_tpu_torch.camera import GOLDEN


class ConfigError(RuntimeError):
    """Raised on missing keys / parse failures (the reference aborts,
    src/util/util.cpp:9-12; a library raises)."""


def parse_properties_text(text: str) -> Dict[str, str]:
    """Parse `key = value # comment` lines (src/properties.cpp:12-32).

    Empty lines and lines without '=' before any '#' are skipped; keys
    and values are whitespace-trimmed; later duplicates win.
    """
    out: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0]
        if "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if key:
            out[key] = value
    return out


class Properties:
    """Typed getters over a parsed key-value map (inc/properties.h:8-18)."""

    def __init__(self, source: str | Path | Dict[str, str]):
        if isinstance(source, dict):
            self._map = dict(source)
        else:
            self._map = parse_properties_text(Path(source).read_text(encoding="utf-8"))

    def get_string_or_null(self, key: str) -> Optional[str]:
        return self._map.get(key)

    def get_string(self, key: str) -> str:
        if key not in self._map:
            raise ConfigError(f"Error! Property {key!r} not found.")
        return self._map[key]

    def _parse(self, key: str, conv, typename: str):
        raw = self.get_string(key)
        try:
            return conv(raw)
        except ValueError as e:
            raise ConfigError(
                f"Error! Property {key!r}: cannot parse {raw!r} as {typename}."
            ) from e

    def get_unsigned_int(self, key: str) -> int:
        v = self._parse(key, int, "unsigned int")
        if v < 0:
            raise ConfigError(f"Error! Property {key!r}: {v} is negative.")
        return v

    def get_float(self, key: str) -> float:
        return self._parse(key, float, "float")

    def get_bool(self, key: str) -> bool:
        raw = self.get_string(key).lower()
        if raw == "true":
            return True
        if raw == "false":
            return False
        raise ConfigError(f"Error! Property {key!r}: {raw!r} is not a bool.")

    def keys(self):
        return self._map.keys()


def _opt_uint(props: "Properties", key: str, default: int) -> int:
    """Optional unsigned key with a default (the reference hard-errors on
    every key it reads; these presentation keys are optional here so a
    reference config file and a minimal one both load)."""
    return props.get_unsigned_int(key) if key in props.keys() else default


def _opt_float(props: "Properties", key: str, default: float) -> float:
    return props.get_float(key) if key in props.keys() else default


@dataclass(frozen=True)
class WindowConfig:
    """window.<type>.* group (src/windows/windows.cpp:6-13): width in
    pixels, cell_size = superpixel size; render resolution = width/cell
    x height/cell; height = width / GOLDEN."""

    title: Optional[str]
    width: int
    cell_size: int

    @property
    def height(self) -> int:
        return int(self.width / GOLDEN)

    @property
    def cells_width(self) -> int:
        return self.width // self.cell_size

    @property
    def cells_height(self) -> int:
        return self.height // self.cell_size


@dataclass(frozen=True)
class CameraConfig:
    focus_to_matrix_distance: float = 1.5
    matrix_height: float = 2.0
    x: float = 0.0
    y: float = -2.0
    z: float = 0.0
    w: float = 0.0
    fi_deg: float = 0.0
    te_deg: float = 0.0
    psi_deg: float = 0.0


@dataclass(frozen=True)
class ControlConfig:
    mouse_sensitivity: float = 0.005
    wheel_sensitivity: float = 0.1
    movement_speed: float = 3.0
    constrain_psi_range: bool = True
    psi_range_radius_deg: float = 45.0
    mouse_border_width: int = 15


@dataclass(frozen=True)
class TextConfig:
    """FPS-overlay text parameters (main.cpp:41-50 initText)."""

    font_filename: Optional[str] = None  # bitmap digits built in; kept for parity
    size: int = 24
    outline_thickness: float = 2.0


@dataclass(frozen=True)
class ScreenConfig:
    """Desktop metrics (main.cpp:19-23). The reference queries the OS
    (VideoMode::getDesktopMode()); headless we take them from config keys
    screen.width/height (defaults = 1920x1080) and subtract the same
    window_title_height/task_bar_height."""

    width: int = 1920
    height: int = 1080
    window_title_height: int = 37
    task_bar_height: int = 60

    @property
    def usable_height(self) -> int:
        return self.height - self.task_bar_height - self.window_title_height


@dataclass(frozen=True)
class AppConfig:
    """Full application config (semantic groups of properties.txt)."""

    show_additional_windows: bool = True
    main_window: WindowConfig = field(
        default_factory=lambda: WindowConfig("Main section", 850, 7)
    )
    additional_window: WindowConfig = field(
        default_factory=lambda: WindowConfig(None, 600, 10)
    )
    samples: int = 100
    reflections_amount: int = 4
    small_indent: float = 0.005
    camera: CameraConfig = field(default_factory=CameraConfig)
    controls: ControlConfig = field(default_factory=ControlConfig)
    light_to_color_conversion_coefficient: float = 1.0
    max_fps: int = 60
    scene: str = "tiger"
    text: TextConfig = field(default_factory=TextConfig)
    screen: ScreenConfig = field(default_factory=ScreenConfig)

    @staticmethod
    def from_properties(props: Properties) -> "AppConfig":
        cam_prefix = "camera.initial_position."
        return AppConfig(
            show_additional_windows=props.get_bool("show_additional_windows"),
            main_window=WindowConfig(
                props.get_string_or_null("window.main.title"),
                props.get_unsigned_int("window.main.width"),
                props.get_unsigned_int("window.main.cell_size"),
            ),
            additional_window=WindowConfig(
                props.get_string_or_null("window.additional.title"),
                props.get_unsigned_int("window.additional.width"),
                props.get_unsigned_int("window.additional.cell_size"),
            ),
            samples=props.get_unsigned_int("ray_tracing.samples"),
            reflections_amount=props.get_unsigned_int("ray_tracing.reflections_amount"),
            small_indent=props.get_float("ray_tracing.small_indent"),
            camera=CameraConfig(
                focus_to_matrix_distance=props.get_float("camera.focus_to_matrix_distance"),
                matrix_height=props.get_float("camera.matrix_height"),
                x=props.get_float(cam_prefix + "x"),
                y=props.get_float(cam_prefix + "y"),
                z=props.get_float(cam_prefix + "z"),
                w=props.get_float(cam_prefix + "w"),
                fi_deg=props.get_float(cam_prefix + "fi"),
                te_deg=props.get_float(cam_prefix + "te"),
                psi_deg=props.get_float(cam_prefix + "psi"),
            ),
            controls=ControlConfig(
                mouse_sensitivity=props.get_float("mouse_sensitivity"),
                wheel_sensitivity=props.get_float("wheel_sensitivity"),
                movement_speed=props.get_float("movement_speed"),
                constrain_psi_range=props.get_bool("constrain_psi_range"),
                psi_range_radius_deg=props.get_float("psi_range_radius"),
                mouse_border_width=props.get_unsigned_int("mouse_border_width"),
            ),
            light_to_color_conversion_coefficient=props.get_float(
                "light_to_color_conversion_coefficient"
            ),
            max_fps=props.get_unsigned_int("max_fps"),
            scene=props.get_string_or_null("scene") or "tiger",
            text=TextConfig(
                font_filename=props.get_string_or_null("text.font.filename"),
                size=_opt_uint(props, "text.size", 24),
                outline_thickness=_opt_float(props, "text.outline_thickness", 2.0),
            ),
            screen=ScreenConfig(
                width=_opt_uint(props, "screen.width", 1920),
                height=_opt_uint(props, "screen.height", 1080),
                window_title_height=_opt_uint(props, "window_title_height", 37),
                task_bar_height=_opt_uint(props, "task_bar_height", 60),
            ),
        )

    @staticmethod
    def load(path: str | Path) -> "AppConfig":
        return AppConfig.from_properties(Properties(path))
