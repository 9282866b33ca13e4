#!/bin/sh
# Build per-OS installable artifacts for the HDF5 vbz filter plugin —
# the counterpart of the reference's CPack packaging
# (reference: packaging/hdf_plugin_packaging.cmake:1-130; package name
# ont-vbz-hdf-plugin, installed into HDF5_PLUGIN_PATH
# /usr/local/hdf5/lib/plugin).
#
# Produces in packaging/dist/:
#   vbz-hdf-plugin-tpu_<ver>.tgz         (archive mode, any OS)
#   vbz-hdf-plugin-tpu_<ver>_<arch>.deb  (when dpkg-deb is available)
set -e
VERSION=${VERSION:-0.1.0}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(dirname "$HERE")
DIST="$HERE/dist"
PLUGIN_DIR=usr/local/hdf5/lib/plugin

make -C "$REPO/native" -s libvbz_hdf_plugin.so

STAGE=$(mktemp -d)
trap 'rm -rf "$STAGE"' EXIT
mkdir -p "$STAGE/root/$PLUGIN_DIR" "$DIST"
install -m 0755 "$REPO/native/libvbz_hdf_plugin.so" \
    "$STAGE/root/$PLUGIN_DIR/"

# TGZ archive (reference: CPACK_GENERATOR TGZ archive mode)
tar -C "$STAGE/root" -czf "$DIST/vbz-hdf-plugin-tpu_${VERSION}.tgz" usr
echo "wrote $DIST/vbz-hdf-plugin-tpu_${VERSION}.tgz"

# DEB (reference: CPACK_GENERATOR DEB, hdf_plugin_packaging.cmake:80-101)
if command -v dpkg-deb >/dev/null 2>&1; then
    ARCH=$(dpkg --print-architecture 2>/dev/null || echo amd64)
    mkdir -p "$STAGE/root/DEBIAN"
    # Postinstall analog of the reference's macOS productbuild script
    # (postinstall.sh.in: symlink the plugin into HDF5_PLUGIN_PATH,
    # hdf_plugin_packaging.cmake:19-48): link the plugin into libhdf5's
    # default plugin search dir when one exists outside our install root.
    cat > "$STAGE/root/DEBIAN/postinst" <<'POST'
#!/bin/sh
set -e
SRC=/usr/local/hdf5/lib/plugin/libvbz_hdf_plugin.so
for d in /usr/lib/x86_64-linux-gnu/hdf5/plugins /usr/lib/hdf5/plugin; do
    if [ -d "$d" ] && [ ! -e "$d/libvbz_hdf_plugin.so" ]; then
        ln -s "$SRC" "$d/libvbz_hdf_plugin.so"
    fi
done
exit 0
POST
    chmod 0755 "$STAGE/root/DEBIAN/postinst"
    cat > "$STAGE/root/DEBIAN/prerm" <<'POST'
#!/bin/sh
for d in /usr/lib/x86_64-linux-gnu/hdf5/plugins /usr/lib/hdf5/plugin; do
    [ -L "$d/libvbz_hdf_plugin.so" ] && rm -f "$d/libvbz_hdf_plugin.so"
done
exit 0
POST
    chmod 0755 "$STAGE/root/DEBIAN/prerm"
    cat > "$STAGE/root/DEBIAN/control" <<CTRL
Package: vbz-hdf-plugin-tpu
Version: $VERSION
Architecture: $ARCH
Maintainer: vbz_compression_tpu
Depends: libzstd1 | libzstd
Description: HDF5 filter plugin (id 32020) for the VBZ codec
 Registers the vbz filter so h5py/h5repack/HDFView transparently read and
 write VBZ-compressed fast5 datasets.
CTRL
    dpkg-deb --build --root-owner-group "$STAGE/root" \
        "$DIST/vbz-hdf-plugin-tpu_${VERSION}_${ARCH}.deb" >/dev/null
    echo "wrote $DIST/vbz-hdf-plugin-tpu_${VERSION}_${ARCH}.deb"
fi
